// Top-2 MoE dispatch by index for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes); see kubeflow_tpu_torch/ops/moe.py.
//
// Replaces the XLA fusions of kubeflow_tpu/parallel/moe.py's gather
// dispatch (there is no Pallas kernel behind them):
//   K12 moe_route    top2_routing (:57-114) with the index maps of
//                    _moe_dispatch_gather (:253-290);
//   K13 moe_gather   _gather_in (:159-165);
//   K14 moe_combine  _combine_out (:187-198);
// and their backward (the training step's):
//   K16 the gather's backward, _gather_in_bwd (:172-180): K14's kernel with
//                    unit weights (no code of its own);
//   K17 moe_combine_bwd  _combine_out_bwd (:206-226);
//   K18 moe_route_bwd    autodiff of top2_routing's g1, g2 and aux (:57-114).
// Slot s = e * G * C + q * C + c holds capacity position c of expert e in
// group q; S = E * G * C is the trash row a dropped choice points at.
//
// K12 on the router logits [T, E] in f32 or in the activations' bf16
// (widened exactly to f32), G groups of g tokens (T = G g), per group:
//   softmax: m = max_j x_j, ex_j = exp(x_j - m), s = ex_0 + ex_1 + .. (left
//     to right), gate_j = ex_j / s; e1 the first argmax of the gates, e2 the
//     first argmax with gate_e1 zeroed;
//   positions: p1 the count of earlier first choices of e1, p2 that of
//     earlier second choices of e2 plus ALL first choices of e2 (the count
//     before the capacity mask);
//   a choice at p >= C is dropped (weight 0), the survivors renormalised by
//     d = w1 + w2 (1 where d <= 0); dest the slot of a choice whose weight
//     is > 0, else S; the group's slots zeroed, then slot_tok / slot_valid
//     set at the kept ones (distinct by construction);
//   aux = E sum_e (sum_t gate_te / g) (count1_e / g), the sum over e left to
//     right and over t by folding halves (zeros past g up to a power of two
//     P, then x[j] += x[j + h] for h = P/2 .. 1).
// Each step is one rounded f32 operation (no contraction) in the order of
// the plain version (route_reference), so the two agree bitwise. Two forms,
// chosen on the host by g (a host value: a CUDA graph captures the choice);
// kE, the compile-time bound of E (8, 16, 32 or 64), keeps a token's
// logits in registers, every load issued before the first is used:
//   moe_route_warp (g <= 32): a warp a group, up to 4 groups a block. Lane
//     t holds token t; a ballot an expert and choice gives each expert's
//     first-choice count and each lane's p1 = popc(ballot(e1) & the lanes
//     below), p2 likewise plus count1[e2]; lanes past g carry an id that
//     matches no expert. The fold by halves
//     is an xor fold over the lanes (zeros past g; fold_lanes), which
//     leaves every lane every expert's sum, so lane j divides expert j's
//     aux term and lane 0 adds the terms. The slots are zeroed first (the
//     stores drain while the logits load), __syncwarp, then the kept ones
//     written: no block barrier and no scratch in device memory.
//   moe_route_group (g > 32): a block, or a thread-block cluster of nb
//     blocks (a power of two up to 8: about 512 tokens a block, which at a
//     4096-token group ran 3.2x faster than one 1024-thread block on an
//     H100, PERF.md), a group; block b takes a contiguous
//     run of the group's 32-token chunks, each warp a contiguous run of its
//     block's. Pass 1: each warp counts its first and second choices per
//     expert (match_any within a chunk; the last lane of each match adds
//     its size to the warp's counter in shared memory). One barrier, then
//     one scan over the warps for every (choice, expert) at once, a warp
//     each; the blocks' totals go over the cluster through distributed
//     shared memory after a cluster barrier. Pass 2 takes each token's
//     choices and match again (kept in registers for a warp's first chunk,
//     recomputed for the others: deterministic) with the warp's counters
//     started at its offsets: the final positions, then the weights, dest
//     and the kept slots (the slots are zeroed before the first barrier;
//     pass 1's rows are prefetched into L1 first). The aux's fold over P
//     tokens is a tree whose first levels pair tokens that share their low
//     bits: with Lw = P / 32, token t = low + Lw lane, the lanes' five
//     levels an xor fold; then low = b + nb (w + Wa r): each warp
//     folds its rounds r by halves (a stack of partial sums in shared
//     memory, the rounds in bit-reversed order), the block its Wa warps by
//     halves, block 0 the nb blocks' partials by halves in rank order
//     (ops/moe.py::aux_fold_reference states the same order in PyTorch).
//
// K13, a thread per 8 elements of a slot's row: out[s] = x[slot_tok[s]] *
// valid[s], the product in f32, rounded to the dtype.
// K14, a thread per 8 elements of a token's row: out[t] = g1 y[dest1] +
// g2 y[dest2] in f32 (__fmul_rn / __fadd_rn), y[S] read as 0, rounded once.
//
// Bound on this card: bytes. K12 reads the logits (T E 2 or 4 bytes) and
// writes 16 bytes a token and 6 a slot; K13 reads x (T M 2 bytes in bf16)
// and writes the S buffer rows; K14 reads the kept choices' rows of y and
// writes T rows. At a decode step (T = 8) each moves well under a MB, a
// fraction of a microsecond at 3.35 TB/s, so a launch is its latency: K12's
// forms keep that chain short (a warp's shuffles at a decode step, two
// block or cluster barriers at a prefill group). Up to ops/norms.py's
// ROWS_MAX rows the served path leaves K14's work to K10's combine mode
// (rms_norm.cu; ops/moe.py::combine_add_rms_norm), which saves its launch.
//
// K17, one launch of two kinds of blocks: the first write dy, a thread per
// 8 elements of a slot's row: t = slot_tok[s], w = (dest1[t] == s ? g1[t] :
// 0) + (dest2[t] == s ? g2[t] : 0), dy[s] = w dout[t] in f32, rounded once;
// the others a warp a token: dg_k[t] = sum_m dout[t, m] y[dest_k[t], m]
// (y[S] read as 0), lane l summing the 8-element chunks l, l + 32, .. in
// order (8 partial sums, zeros past M), then the 8 folded by halves, then
// the lanes by an xor fold: ops/moe.py::row_dot_reference's order. Bound:
// bytes (dout and the kept y rows read, dy written).
// K18, per group: the gates, e1 and e2 recomputed as K12 computes them
// (gates_top2), count1 (first choices before the capacity mask) by
// match_any and shared atomics (integers: exact in any order), then per
// token with kept_k = dest_k < S, a_k = kept_k gate[e_k], d = a1 + a2 (1
// where 0), w_k = a_k / d:
//   da_k = kept_k ? (dg_k - (dg1 w1 + dg2 w2)) / d : 0,
//   dgate_e = ([e == e1] da1 + [e == e2] da2) + (daux E (count1_e / g)) / g,
//   dl_e = gate_e (dgate_e - sum_j dgate_j gate_j), the sum left to right,
// rounded to the logits' dtype (route_backward_reference). A cluster of
// blocks a group as K12's group form (about 512 tokens a block, the counts
// over distributed shared memory), a thread a token, its gates kept in
// registers from the counting pass. Bound: bytes, under a microsecond at
// a train step's 4096 tokens at the H100's 3.35 TB/s; a launch is its
// latency.
// The measured times are in PERF.md.

#include <cooperative_groups.h>

#include "fused_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace kftpu_fused;

constexpr int kMaxExperts = 64;
constexpr int kRowThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarpGroups = 4;        // moe_route_warp: groups (warps) a block
constexpr int kMaxCluster = 8;        // moe_route_group: blocks a group (portable)
constexpr int kStackLevels = 11;      // a warp's rounds R <= 2^10
constexpr int kMaxGroupTokens = 1 << 18;

// Threads a block of moe_route_group: a thread's kE logits in registers.
template <int kE>
__host__ __device__ constexpr int group_threads() {
  return kE <= 8 ? 1024 : (kE <= 32 ? 512 : 256);
}

// Token ``row``'s gates and its two choices: gt[j] = ex_j / s with ex_j =
// exp(x_j - m) and s their sum left to right; e1 and e2 with their gates
// ge1, ge2 (ge2 the gate itself, not the zeroed one, as the plain version
// gathers it). The kE - E entries past E start at -inf, so their gates are
// exact zeros that change neither m, s nor a choice: every loop runs the
// same straight code for every E (no branch around a shuffle or a
// division, which would serialise them). Each division once, before the
// argmaxes, so that few values are live across its slow path.
template <int kE, typename L>
__device__ __forceinline__ void gates_top2(const L* __restrict__ row, int E, float (&gt)[kE],
                                           int& e1, int& e2, float& ge1, float& ge2) {
#pragma unroll
  for (int j = 0; j < kE; ++j) gt[j] = j < E ? load1(row + j) : __int_as_float(0xff800000);
  float m = gt[0];
#pragma unroll
  for (int j = 1; j < kE; ++j) m = gt[j] > m ? gt[j] : m;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    gt[j] = expf(__fsub_rn(gt[j], m));
    s = j ? __fadd_rn(s, gt[j]) : gt[j];
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) gt[j] = __fdiv_rn(gt[j], s);
  e1 = 0;
  ge1 = gt[0];
#pragma unroll
  for (int j = 1; j < kE; ++j)
    if (gt[j] > ge1) { ge1 = gt[j]; e1 = j; }
  e2 = 0;
  ge2 = gt[0];
  float b2 = e1 == 0 ? 0.f : gt[0];
#pragma unroll
  for (int j = 1; j < kE; ++j) {
    const float z = j == e1 ? 0.f : gt[j];
    if (z > b2) { b2 = z; e2 = j; ge2 = gt[j]; }
  }
}

// The group's E C slots zeroed, items first, first + step, ... (every slot
// index is below 2^31: the entry checks E G C).
template <typename V>
__device__ __forceinline__ void zero_slots(int q, int E, int C, int GC, int first, int step,
                                           int* __restrict__ slot_tok,
                                           V* __restrict__ slot_valid) {
  for (int i = first; i < E * C; i += step) {
    const int s = (i / C) * GC + q * C + i % C;
    slot_tok[s] = 0;
    store1(slot_valid + s, 0.f);
  }
}

// Token ``tok`` of group q from its choices and positions: the capacity
// masks, the renormalised weights, dest and its kept slots.
template <typename V>
__device__ __forceinline__ void place(int tok, int q, int C, int GC, int trash, int e1, int e2,
                                      float ge1, float ge2, int p1, int p2,
                                      int* __restrict__ dest1, int* __restrict__ dest2,
                                      float* __restrict__ w1, float* __restrict__ w2,
                                      int* __restrict__ slot_tok, V* __restrict__ slot_valid) {
  const float a = p1 < C ? ge1 : 0.f;
  const float b = p2 < C ? ge2 : 0.f;
  float d = __fadd_rn(a, b);
  d = d > 0.f ? d : 1.f;
  const float x1 = __fdiv_rn(a, d), x2 = __fdiv_rn(b, d);
  const int s1 = x1 > 0.f ? e1 * GC + q * C + p1 : trash;
  const int s2 = x2 > 0.f ? e2 * GC + q * C + p2 : trash;
  w1[tok] = x1;
  w2[tok] = x2;
  dest1[tok] = s1;
  dest2[tok] = s2;
  if (s1 < trash) {
    slot_tok[s1] = tok;
    store1(slot_valid + s1, 1.f);
  }
  if (s2 < trash) {
    slot_tok[s2] = tok;
    store1(slot_valid + s2, 1.f);
  }
}

// The gates of every expert folded by halves over the warp's 32 lanes
// (zeros past the tokens), into every lane: level h = 16 .. 1 adds lane i
// ^ h's value to lane i's. Lane i < h gets x[i] + x[i + h], the fold's
// pair, and lane i + h the same sum, so after the last level every lane
// holds lane 0's fold; levels past the padded length P add zeros, which
// change nothing. The experts' shuffles of one level are independent, so
// they overlap.
template <int kE>
__device__ __forceinline__ void fold_lanes(float (&gt)[kE]) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < kE; ++j) gt[j] = __fadd_rn(gt[j], __shfl_xor_sync(kAll, gt[j], h));
  }
}

// ``v[j]`` of expert j for the lane that handles it: lane j holds expert j
// in ``lo`` and expert j + 32 in ``hi`` (register arrays are indexed at
// compile time only).
template <int kE, typename X>
__device__ __forceinline__ void own_experts(const X (&v)[kE], int lane, X& lo, X& hi) {
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (lane == (j & 31)) {
      if (j < 32) {
        lo = v[j];
      } else {
        hi = v[j];
      }
    }
  }
}

// The 16 bytes (one line) of a logits row into L1 ahead of its load.
template <typename L>
__device__ __forceinline__ void prefetch_row(const L* row) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(row));
}

// aux = E sum_e (gate sum_e / g) (count1_e / g), the sum over e left to
// right, written by lane 0, from ``sums`` and ``count1`` (every lane holds
// them): lane j computes expert j's term (and j + 32's), so the divisions
// run side by side.
template <int kE>
__device__ __forceinline__ void aux_terms(const float (&sums)[kE], const int (&count1)[kE], int E,
                                          int g, int lane, float* __restrict__ aux) {
  float s_lo = 0.f, s_hi = 0.f;
  int c_lo = 0, c_hi = 0;
  own_experts<kE>(sums, lane, s_lo, s_hi);
  own_experts<kE>(count1, lane, c_lo, c_hi);
  const float n = static_cast<float>(g);
  const float p_lo = __fmul_rn(__fdiv_rn(s_lo, n), __fdiv_rn(static_cast<float>(c_lo), n));
  const float p_hi =
      kE > 32 ? __fmul_rn(__fdiv_rn(s_hi, n), __fdiv_rn(static_cast<float>(c_hi), n)) : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const float pj = __shfl_sync(kAll, j < 32 ? p_lo : p_hi, j & 31);
    acc = j == 0 ? pj : (j < E ? __fadd_rn(acc, pj) : acc);
  }
  if (lane == 0) *aux = __fmul_rn(acc, static_cast<float>(E));
}

// K12's warp form (g <= 32): warp i of the block routes group
// blockIdx.x * kWarpGroups + i. L: the logits' storage type; V:
// slot_valid's (the activations').
template <typename L, typename V, int kE>
__global__ void __launch_bounds__(32 * kWarpGroups)
    moe_route_warp(const L* __restrict__ logits, int g, int E, int G, int C,
                   int* __restrict__ dest1, int* __restrict__ dest2, float* __restrict__ w1,
                   float* __restrict__ w2, int* __restrict__ slot_tok,
                   V* __restrict__ slot_valid, float* __restrict__ aux) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * kWarpGroups + threadIdx.x / 32;
  if (q >= G) return;                     // the whole warp
  const long long t0 = static_cast<long long>(q) * g;
  const int GC = G * C;
  zero_slots(q, E, C, GC, lane, 32, slot_tok, slot_valid);  // drains meanwhile
  const bool live = lane < g;
  float gt[kE], ge1 = 0.f, ge2 = 0.f;
  int e1 = -1, e2 = -1;                   // past g: an id no expert has
  if (live) {
    gates_top2<kE>(logits + (t0 + lane) * E, E, gt, e1, e2, ge1, ge2);
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) gt[j] = 0.f;
  }
  // A ballot an expert and choice: count1, and each lane's positions
  // (the lanes below it with its expert); the gates' sums by a fold over
  // the lanes; lane j takes expert j's aux term, lane 0 sums them in order.
  const unsigned below = (1u << lane) - 1u;
  int count1[kE], p1 = 0, p2 = 0;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const unsigned b1 = __ballot_sync(kAll, e1 == j);
    const unsigned b2 = __ballot_sync(kAll, e2 == j);
    count1[j] = __popc(b1);
    if (e1 == j) p1 = __popc(b1 & below);
    if (e2 == j) p2 = __popc(b2 & below) + count1[j];
  }
  fold_lanes<kE>(gt);
  aux_terms<kE>(gt, count1, E, g, lane, aux + q);
  __syncwarp();                           // the zeroed slots before the kept ones
  if (live) {
    place(static_cast<int>(t0) + lane, q, C, GC, E * GC, e1, e2, ge1, ge2, p1, p2, dest1, dest2,
          w1, w2, slot_tok, slot_valid);
  }
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ``p`` in the shared memory of the cluster's block ``rank`` (this block's
// own where there is no cluster).
template <typename X>
__device__ __forceinline__ X* in_block(X* p, int rank, int nb) {
  return nb > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// K12's group form (g > 32): nb blocks a group (a cluster of nb when nb >
// 1), block rank b = blockIdx.x % nb of group blockIdx.x / nb.
template <typename L, typename V, int kE>
__global__ void __launch_bounds__(group_threads<kE>(), 1)
    moe_route_group(const L* __restrict__ logits, int g, int E, int G, int C, int nb,
                    int* __restrict__ dest1, int* __restrict__ dest2, float* __restrict__ w1,
                    float* __restrict__ w2, int* __restrict__ slot_tok,
                    V* __restrict__ slot_valid, float* __restrict__ aux) {
  constexpr int kThreads = group_threads<kE>();
  constexpr int kWarps = kThreads / 32;
  __shared__ int count[2][kWarps][kE];    // a warp's counts, then its next positions
  __shared__ int block_total[2][kE];      // read by the cluster's blocks
  __shared__ float stack[kWarps][kStackLevels][kE];
  __shared__ float block_part[kE];        // the block's aux partial, read by block 0
  __shared__ float parts[kMaxCluster][kE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % nb, q = blockIdx.x / nb;
  const int t0 = q * g;
  const L* x = logits + static_cast<long long>(t0) * E;
  const int GC = G * C;
  const unsigned below = (1u << lane) - 1u;

  // This warp's 32-token chunks (passes 1 and 2), their rows prefetched.
  const int chunks = (g + 31) / 32;
  const int per_block = (chunks + nb - 1) / nb;
  const int per_warp = (per_block + kWarps - 1) / kWarps;
  const int block_end = min(chunks, (rank + 1) * per_block);
  const int c0 = rank * per_block + warp * per_warp;
  const int c1 = min(block_end, c0 + per_warp);
  for (int c = c0; c < c1; ++c)
    if (c * 32 + lane < g) prefetch_row(x + static_cast<long long>(c * 32 + lane) * E);
  zero_slots(q, E, C, GC, rank * kThreads + threadIdx.x, nb * kThreads, slot_tok, slot_valid);
  for (int i = lane; i < 2 * kE; i += 32) count[i / kE][warp][i % kE] = 0;

  // The aux's partial sums: token t = low + Lw lane, low = rank + nb (warp
  // + Wa r), the rounds r in bit-reversed order onto the warp's stack.
  int P = 64;
  while (P < g) P <<= 1;
  const int Lw = P / 32;
  const int Wa = min(kWarps, Lw / nb);
  const int R = Lw / (nb * Wa);
  int logR = 0;
  while ((1 << logR) < R) ++logR;
  if (warp < Wa) {
    for (int k = 0; k < R; ++k) {
      const int r = logR ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logR)) : 0;
      const long long t = rank + static_cast<long long>(nb) * (warp + Wa * r) +
                          static_cast<long long>(Lw) * lane;
      float gt[kE], ge1, ge2;
      int e1, e2;
      if (t < g) {
        gates_top2<kE>(x + t * E, E, gt, e1, e2, ge1, ge2);
      } else {
#pragma unroll
        for (int j = 0; j < kE; ++j) gt[j] = 0.f;
      }
      fold_lanes<kE>(gt);
      // Round k joins the partial sums below it, lane j on expert j's
      // column (and j + 32's).
      float v_lo = 0.f, v_hi = 0.f;
      own_experts<kE>(gt, lane, v_lo, v_hi);
      for (int half = 0; half < (kE > 32 ? 2 : 1); ++half) {
        const int j = lane + 32 * half;
        if (j < E) {
          float v = half ? v_hi : v_lo;
          int level = 0;
          for (; (k >> level) & 1; ++level) v = __fadd_rn(stack[warp][level][j], v);
          stack[warp][level][j] = v;
        }
      }
    }
  }

  // Pass 1: the warp's counts of first and second choices per expert; the
  // first chunk's choices and matches stay in registers for pass 2.
  int first_e1 = -1, first_e2 = -1;
  float first_ge1 = 0.f, first_ge2 = 0.f;
  unsigned first_m1 = 0u, first_m2 = 0u;
  __syncwarp();
  for (int c = c0; c < c1; ++c) {
    const int t = c * 32 + lane;
    float gt[kE], ge1 = 0.f, ge2 = 0.f;
    int e1 = -1, e2 = -1;
    if (t < g) gates_top2<kE>(x + static_cast<long long>(t) * E, E, gt, e1, e2, ge1, ge2);
    const unsigned m1 = __match_any_sync(kAll, e1), m2 = __match_any_sync(kAll, e2);
    if (t < g && (m1 >> lane) == 1u) count[0][warp][e1] += __popc(m1);
    if (t < g && (m2 >> lane) == 1u) count[1][warp][e2] += __popc(m2);
    if (c == c0) {
      first_e1 = e1;
      first_e2 = e2;
      first_ge1 = ge1;
      first_ge2 = ge2;
      first_m1 = m1;
      first_m2 = m2;
    }
    __syncwarp();
  }
  __syncthreads();

  // One scan over the warps for every (choice, expert), a warp each; the
  // block's aux partial folds its Wa warps by halves.
  for (int i = warp; i < 3 * E; i += kWarps) {
    if (i < 2 * E) {
      const int c = i / E, e = i % E;
      const int v = lane < kWarps ? count[c][lane][e] : 0;
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kAll, inc, o);
        if (lane >= o) inc += up;
      }
      if (lane < kWarps) count[c][lane][e] = inc - v;
      if (lane == 31) block_total[c][e] = inc;
    } else {
      const int e = i - 2 * E;
      float v = lane < Wa ? stack[lane][logR][e] : 0.f;
      for (int h = Wa / 2; h >= 1; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(kAll, v, h));
      if (lane == 0) block_part[e] = v;
    }
  }
  if (nb > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // The warp's positions start after the earlier blocks' and warps' choices
  // of each expert (second choices after all first ones); block 0 warp 0
  // folds the blocks' aux partials by halves and writes the aux.
  const bool aux_warp = rank == 0 && warp == 0;
  const float n = static_cast<float>(g);
  for (int e = lane; e < E; e += 32) {
    int total1 = 0, before1 = 0, before2 = 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) {
      if (b < nb) {
        const int* bt = in_block(&block_total[0][0], b, nb);
        const int a1 = bt[e], a2 = bt[kE + e];
        total1 += a1;
        if (b < rank) {
          before1 += a1;
          before2 += a2;
        }
      }
    }
    count[0][warp][e] += before1;
    count[1][warp][e] += total1 + before2;
    if (aux_warp) {
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)
        if (b < nb) parts[b][e] = in_block(block_part, b, nb)[e];
      for (int h = nb / 2; h >= 1; h >>= 1)
        for (int i = 0; i < h; ++i) parts[i][e] = __fadd_rn(parts[i][e], parts[i + h][e]);
      parts[0][e] = __fmul_rn(__fdiv_rn(parts[0][e], n),
                              __fdiv_rn(static_cast<float>(total1), n));
    }
  }
  __syncwarp();
  if (aux_warp && lane == 0) {
    float acc = parts[0][0];
    for (int e = 1; e < E; ++e) acc = __fadd_rn(acc, parts[0][e]);
    aux[q] = __fmul_rn(acc, static_cast<float>(E));
  }
  if (nb > 1) cluster_arrive_release();   // done reading the cluster's blocks

  // Pass 2: the final positions, the weights, dest and the kept slots.
  const int trash = E * GC;
  for (int c = c0; c < c1; ++c) {
    const int t = c * 32 + lane;
    const bool live = t < g;
    float gt[kE], ge1 = first_ge1, ge2 = first_ge2;
    int e1 = first_e1, e2 = first_e2;
    unsigned m1 = first_m1, m2 = first_m2;
    if (c != c0) {                        // recomputed: deterministic
      e1 = e2 = -1;
      if (live) gates_top2<kE>(x + static_cast<long long>(t) * E, E, gt, e1, e2, ge1, ge2);
      m1 = __match_any_sync(kAll, e1);
      m2 = __match_any_sync(kAll, e2);
    }
    const int p1 = live ? count[0][warp][e1] + __popc(m1 & below) : 0;
    const int p2 = live ? count[1][warp][e2] + __popc(m2 & below) : 0;
    __syncwarp();
    if (live && (m1 >> lane) == 1u) count[0][warp][e1] += __popc(m1);
    if (live && (m2 >> lane) == 1u) count[1][warp][e2] += __popc(m2);
    __syncwarp();
    if (live) {
      place(t0 + t, q, C, GC, trash, e1, e2, ge1, ge2, p1, p2, dest1, dest2, w1, w2, slot_tok,
            slot_valid);
    }
  }
  if (nb > 1) cluster_wait_acquire();     // no block leaves while another reads it
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    moe_gather(const T* __restrict__ x, const int* __restrict__ slot_tok,
               const T* __restrict__ valid, T* __restrict__ out, int M, long long items) {
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= items) return;
  const int per_row = M / 8;
  const long long s = i / per_row;
  const int col = static_cast<int>(i % per_row) * 8;
  const float v = load1(valid + s);
  float a[8];
  load8(x + static_cast<long long>(slot_tok[s]) * M + col, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = __fmul_rn(a[j], v);
  store8(out + s * M + col, a);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    moe_combine(const T* __restrict__ y, const float* __restrict__ g1,
                const float* __restrict__ g2, const int* __restrict__ dest1,
                const int* __restrict__ dest2, T* __restrict__ out, long long S, int M,
                long long items) {
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= items) return;
  const int per_row = M / 8;
  const long long t = i / per_row;
  const int col = static_cast<int>(i % per_row) * 8;
  const long long d1 = dest1[t], d2 = dest2[t];
  const float wa = g1[t], wb = g2[t];
  float a[8], b[8], o[8];
  if (d1 < S) {
    load8(y + d1 * M + col, a);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.f;
  }
  if (d2 < S) {
    load8(y + d2 * M + col, b);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(__fmul_rn(wa, a[j]), __fmul_rn(wb, b[j]));
  store8(out + t * M + col, o);
}

long long blocks_for(long long items) { return (items + kRowThreads - 1) / kRowThreads; }

// K17: blocks below dy_blocks write dy [S, M]; the rest take a token a warp
// for dg1, dg2 [T].
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    moe_combine_bwd(const T* __restrict__ dout, const T* __restrict__ y,
                    const float* __restrict__ g1, const float* __restrict__ g2,
                    const int* __restrict__ dest1, const int* __restrict__ dest2,
                    const int* __restrict__ slot_tok, T* __restrict__ dy, float* __restrict__ dg1,
                    float* __restrict__ dg2, long long tokens, long long S, int M,
                    long long dy_blocks) {
  const int per_row = M / 8;
  if (blockIdx.x < dy_blocks) {
    const long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
    if (i >= S * per_row) return;
    const long long s = i / per_row;
    const int col = static_cast<int>(i % per_row) * 8;
    const int t = slot_tok[s];
    const float w = __fadd_rn(dest1[t] == s ? g1[t] : 0.f, dest2[t] == s ? g2[t] : 0.f);
    float a[8];
    load8(dout + static_cast<long long>(t) * M + col, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = __fmul_rn(w, a[j]);
    store8(dy + s * M + col, a);
    return;
  }
  const int lane = threadIdx.x % 32;
  const long long t =
      (static_cast<long long>(blockIdx.x) - dy_blocks) * (kRowThreads / 32) + threadIdx.x / 32;
  if (t >= tokens) return;                // the whole warp
  const long long d1 = dest1[t], d2 = dest2[t];
  const int rounds = (per_row + 31) / 32;
  float a1[8], a2[8];
  for (int k = 0; k < rounds; ++k) {
    const int c = k * 32 + lane;
    float o[8], p[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = q[j] = 0.f;
    if (c < per_row) {
      load8(dout + t * M + c * 8, o);
      if (d1 < S) load8(y + d1 * M + c * 8, p);
      if (d2 < S) load8(y + d2 * M + c * 8, q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j] = __fmul_rn(o[j], p[j]);     // the trash row's products too
        q[j] = __fmul_rn(o[j], q[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a1[j] = k ? __fadd_rn(a1[j], p[j]) : p[j];
      a2[j] = k ? __fadd_rn(a2[j], q[j]) : q[j];
    }
  }
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      a1[j] = __fadd_rn(a1[j], a1[j + h]);
      a2[j] = __fadd_rn(a2[j], a2[j + h]);
    }
  }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    a1[0] = __fadd_rn(a1[0], __shfl_xor_sync(kAll, a1[0], h));
    a2[0] = __fadd_rn(a2[0], __shfl_xor_sync(kAll, a2[0], h));
  }
  if (lane == 0) {
    dg1[t] = a1[0];
    dg2[t] = a2[0];
  }
}

// Threads a block of moe_route_bwd: a thread's kE gates in registers.
template <int kE>
__host__ __device__ constexpr int bwd_threads() {
  return kE <= 16 ? 512 : 256;
}

// K18: nb blocks a group (a cluster of nb when nb > 1), block rank b =
// blockIdx.x % nb of group blockIdx.x / nb taking a contiguous run of the
// group's tokens, a thread a token a round.
template <typename L, int kE>
__global__ void __launch_bounds__(bwd_threads<kE>(), 1)
    moe_route_bwd(const L* __restrict__ logits, int g, int E, int nb, int trash,
                  const int* __restrict__ dest1, const int* __restrict__ dest2,
                  const float* __restrict__ dg1, const float* __restrict__ dg2,
                  const float* __restrict__ daux, L* __restrict__ dl) {
  constexpr int kThreads = bwd_threads<kE>();
  __shared__ int count[kE];               // this block's first choices, read by the cluster
  __shared__ float aux_grad[kE];
  const int lane = threadIdx.x % 32;
  const int rank = blockIdx.x % nb, q = blockIdx.x / nb;
  const long long t0 = static_cast<long long>(q) * g;
  const int per = (g + nb - 1) / nb;
  const int lo = rank * per, hi = min(g, lo + per);
  for (int j = threadIdx.x; j < kE; j += kThreads) count[j] = 0;
  __syncthreads();

  // Pass 1: the first choices' counts; the first round's token stays in
  // registers, its per-token inputs loaded before the barrier.
  float gt0[kE], ge1_0 = 0.f, ge2_0 = 0.f, dg1_0 = 0.f, dg2_0 = 0.f;
  int e1_0 = -1, e2_0 = -1;
  bool kept1_0 = false, kept2_0 = false;
  for (int base = lo; base < hi; base += kThreads) {
    const int t = base + threadIdx.x;
    const bool live = t < hi;
    float gt[kE], ge1 = 0.f, ge2 = 0.f;
    int e1 = -1, e2 = -1;
    if (live) gates_top2<kE>(logits + (t0 + t) * E, E, gt, e1, e2, ge1, ge2);
    if (base == lo && live) {
      kept1_0 = dest1[t0 + t] < trash;
      kept2_0 = dest2[t0 + t] < trash;
      dg1_0 = dg1[t0 + t];
      dg2_0 = dg2[t0 + t];
#pragma unroll
      for (int j = 0; j < kE; ++j) gt0[j] = gt[j];
      e1_0 = e1;
      e2_0 = e2;
      ge1_0 = ge1;
      ge2_0 = ge2;
    }
    const unsigned m = __match_any_sync(kAll, e1);
    if (live && (m >> lane) == 1u) atomicAdd(&count[e1], __popc(m));
  }
  if (nb > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // The aux's term of each expert's gate gradient, from the group's counts.
  const float n = static_cast<float>(g);
  const float coef = __fmul_rn(daux[q], static_cast<float>(E));
  for (int j = threadIdx.x; j < E; j += kThreads) {
    int total = 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b)
      if (b < nb) total += in_block(count, b, nb)[j];
    aux_grad[j] = __fdiv_rn(__fmul_rn(coef, __fdiv_rn(static_cast<float>(total), n)), n);
  }
  if (nb > 1) cluster_arrive_release();   // done reading the cluster's blocks
  __syncthreads();

  // Pass 2: each token's gradient of its logits.
  for (int base = lo; base < hi; base += kThreads) {
    const int t = base + threadIdx.x;
    if (t >= hi) continue;
    float gt[kE], ge1 = ge1_0, ge2 = ge2_0, d1 = dg1_0, d2 = dg2_0;
    int e1 = e1_0, e2 = e2_0;
    bool kept1 = kept1_0, kept2 = kept2_0;
    if (base == lo) {
#pragma unroll
      for (int j = 0; j < kE; ++j) gt[j] = gt0[j];
    } else {                              // recomputed: deterministic
      gates_top2<kE>(logits + (t0 + t) * E, E, gt, e1, e2, ge1, ge2);
      kept1 = dest1[t0 + t] < trash;
      kept2 = dest2[t0 + t] < trash;
      d1 = dg1[t0 + t];
      d2 = dg2[t0 + t];
    }
    const float a1 = kept1 ? ge1 : 0.f, a2 = kept2 ? ge2 : 0.f;
    float den = __fadd_rn(a1, a2);
    den = den > 0.f ? den : 1.f;
    const float w1 = __fdiv_rn(a1, den), w2 = __fdiv_rn(a2, den);
    const float dot = __fadd_rn(__fmul_rn(d1, w1), __fmul_rn(d2, w2));
    const float da1 = kept1 ? __fdiv_rn(__fsub_rn(d1, dot), den) : 0.f;
    const float da2 = kept2 ? __fdiv_rn(__fsub_rn(d2, dot), den) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (j < E) {
        const float dg = __fadd_rn(__fadd_rn(j == e1 ? da1 : 0.f, j == e2 ? da2 : 0.f), aux_grad[j]);
        const float p = __fmul_rn(dg, gt[j]);
        s = j ? __fadd_rn(s, p) : p;
      }
    }
    L* out = dl + (t0 + t) * E;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (j < E) {
        const float dg = __fadd_rn(__fadd_rn(j == e1 ? da1 : 0.f, j == e2 ? da2 : 0.f), aux_grad[j]);
        store1(out + j, __fmul_rn(gt[j], __fsub_rn(dg, s)));
      }
    }
  }
  if (nb > 1) cluster_wait_acquire();     // no block leaves while another reads it
}

// K18 at the compile-time bound kE of E: nb blocks a group, about 512
// tokens a block (1 up to 512 tokens, 2 up to 1024, 4 up to 2048, 8 above).
template <typename L, int kE>
cudaError_t launch_route_bwd(const L* lg, int g, int E, int G, int trash, const int* d1,
                             const int* d2, const float* dg1, const float* dg2, const float* daux,
                             L* dl, cudaStream_t st) {
  constexpr int kThreads = bwd_threads<kE>();
  int nb = 1;
  while (nb < kMaxCluster && nb * 512 < g) nb *= 2;
  if (static_cast<long long>(G) * nb >= (1LL << 31)) return cudaErrorInvalidValue;
  if (nb == 1) {
    moe_route_bwd<L, kE><<<G, kThreads, 0, st>>>(lg, g, E, 1, trash, d1, d2, dg1, dg2, daux, dl);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G * nb));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, moe_route_bwd<L, kE>, lg, g, E, nb, trash, d1,
                                             d2, dg1, dg2, daux, dl);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename L>
cudaError_t route_bwd_bound(const L* lg, int g, int E, int G, int trash, const int* d1,
                            const int* d2, const float* dg1, const float* dg2, const float* daux,
                            L* dl, cudaStream_t st) {
  if (E <= 8) return launch_route_bwd<L, 8>(lg, g, E, G, trash, d1, d2, dg1, dg2, daux, dl, st);
  if (E <= 16) return launch_route_bwd<L, 16>(lg, g, E, G, trash, d1, d2, dg1, dg2, daux, dl, st);
  if (E <= 32) return launch_route_bwd<L, 32>(lg, g, E, G, trash, d1, d2, dg1, dg2, daux, dl, st);
  return launch_route_bwd<L, 64>(lg, g, E, G, trash, d1, d2, dg1, dg2, daux, dl, st);
}

// K12 at the compile-time bound kE of E: the warp form at g <= 32, else the
// group form over nb blocks a group, about 512 tokens a block (1 up to 512
// tokens, 2 up to 1024, 4 up to 2048, 8 above), at most Lw = P / 32.
template <typename L, typename V, int kE>
cudaError_t launch_route(const L* lg, int g, int E, int G, int C, int* d1, int* d2, float* a,
                         float* b, int* tok, V* valid, float* ax, cudaStream_t st) {
  if (g <= 32) {
    const int blocks = (G + kWarpGroups - 1) / kWarpGroups;
    moe_route_warp<L, V, kE><<<blocks, 32 * min(G, kWarpGroups), 0, st>>>(
        lg, g, E, G, C, d1, d2, a, b, tok, valid, ax);
    return cudaGetLastError();
  }
  constexpr int kThreads = group_threads<kE>();
  int P = 64;
  while (P < g) P <<= 1;
  int nb = 1;
  while (nb < kMaxCluster && nb * 512 < g && 2 * nb <= P / 32) nb *= 2;
  if (static_cast<long long>(G) * nb >= (1LL << 31)) return cudaErrorInvalidValue;
  if (nb == 1) {
    moe_route_group<L, V, kE><<<G, kThreads, 0, st>>>(lg, g, E, G, C, 1, d1, d2, a, b, tok,
                                                       valid, ax);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G * nb));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, moe_route_group<L, V, kE>, lg, g, E, G, C, nb,
                                             d1, d2, a, b, tok, valid, ax);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename L, typename V>
cudaError_t route_bound(const L* lg, int g, int E, int G, int C, int* d1, int* d2, float* a,
                        float* b, int* tok, V* valid, float* ax, cudaStream_t st) {
  if (E <= 8) return launch_route<L, V, 8>(lg, g, E, G, C, d1, d2, a, b, tok, valid, ax, st);
  if (E <= 16) return launch_route<L, V, 16>(lg, g, E, G, C, d1, d2, a, b, tok, valid, ax, st);
  if (E <= 32) return launch_route<L, V, 32>(lg, g, E, G, C, d1, d2, a, b, tok, valid, ax, st);
  return launch_route<L, V, 64>(lg, g, E, G, C, d1, d2, a, b, tok, valid, ax, st);
}

}  // namespace

// K12: routing of logits [T, E] (contiguous; logits_dtype and valid_dtype:
// 0 f32, 1 bf16) in G groups of g = T / G tokens (at most 2^18), C slots an
// expert a group. Writes dest1, dest2 [T] int32, w1, w2 [T] f32, slot_tok
// [E G C] int32, slot_valid [E G C] and aux [G] f32, and nothing else: the
// warp form at g <= 32, else the group form. Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int kftpu_moe_route(const void* logits, int logits_dtype, long long T, int E, int G,
                               int C, int valid_dtype, void* dest1, void* dest2, void* w1,
                               void* w2, void* slot_tok, void* slot_valid, void* aux,
                               void* stream) {
  if (E < 2 || E > kMaxExperts || G < 1 || C < 1 || T < G || T % G != 0 ||
      (valid_dtype != kF32 && valid_dtype != kBF16) ||
      (logits_dtype != kF32 && logits_dtype != kBF16) ||
      static_cast<long long>(E) * G * C >= (1LL << 31) || T >= (1LL << 31) ||
      T / G > kMaxGroupTokens)
    return cudaErrorInvalidValue;
  const int g = static_cast<int>(T / G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int *d1 = static_cast<int*>(dest1), *d2 = static_cast<int*>(dest2);
  float *a = static_cast<float*>(w1), *b = static_cast<float*>(w2);
  int* tok = static_cast<int*>(slot_tok);
  float* ax = static_cast<float*>(aux);
  auto launch = [&](auto* lg) {
    return valid_dtype == kBF16
               ? route_bound(lg, g, E, G, C, d1, d2, a, b, tok,
                             static_cast<__nv_bfloat16*>(slot_valid), ax, st)
               : route_bound(lg, g, E, G, C, d1, d2, a, b, tok,
                             static_cast<float*>(slot_valid), ax, st);
  };
  return logits_dtype == kBF16 ? launch(static_cast<const __nv_bfloat16*>(logits))
                               : launch(static_cast<const float*>(logits));
}

// K13: out [S, M] = x[slot_tok[s]] * valid[s] for x [T, M] (contiguous,
// 16-byte aligned rows, M a multiple of 8); dtype 0 f32, 1 bf16 for x,
// valid and out. Returns the CUDA error code of the launch.
extern "C" int kftpu_moe_gather(int dtype, const void* x, const void* slot_tok,
                                const void* valid, void* out, long long S, int M,
                                void* stream) {
  const long long items = S * (M / 8);
  if ((dtype != kF32 && dtype != kBF16) || S < 1 || M < 8 || M % 8 != 0 ||
      blocks_for(items) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(blocks_for(items));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(slot_tok);
  if (dtype == kBF16) {
    using B = __nv_bfloat16;
    moe_gather<B><<<blocks, kRowThreads, 0, st>>>(static_cast<const B*>(x), tok,
                                                   static_cast<const B*>(valid),
                                                   static_cast<B*>(out), M, items);
  } else {
    moe_gather<float><<<blocks, kRowThreads, 0, st>>>(static_cast<const float*>(x), tok,
                                                       static_cast<const float*>(valid),
                                                       static_cast<float*>(out), M, items);
  }
  return cudaGetLastError();
}

// K14: out [T, M] = g1 y[dest1] + g2 y[dest2] for y [S, M] (row S reads as
// 0); dtype 0 f32, 1 bf16 for y and out. Returns the CUDA error code of the
// launch.
extern "C" int kftpu_moe_combine(int dtype, const void* y, const void* g1, const void* g2,
                                 const void* dest1, const void* dest2, void* out, long long T,
                                 long long S, int M, void* stream) {
  const long long items = T * (M / 8);
  if ((dtype != kF32 && dtype != kBF16) || T < 1 || S < 1 || M < 8 || M % 8 != 0 ||
      blocks_for(items) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(blocks_for(items));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(g1), *b = static_cast<const float*>(g2);
  const int *d1 = static_cast<const int*>(dest1), *d2 = static_cast<const int*>(dest2);
  if (dtype == kBF16) {
    using B = __nv_bfloat16;
    moe_combine<B><<<blocks, kRowThreads, 0, st>>>(static_cast<const B*>(y), a, b, d1, d2,
                                                    static_cast<B*>(out), S, M, items);
  } else {
    moe_combine<float><<<blocks, kRowThreads, 0, st>>>(static_cast<const float*>(y), a, b, d1,
                                                        d2, static_cast<float*>(out), S, M,
                                                        items);
  }
  return cudaGetLastError();
}

// K17: the combine's backward for dout [T, M] and y [S, M] (dtype 0 f32, 1
// bf16 for both and dy; contiguous, 16-byte aligned rows, M a multiple of
// 8): dy [S, M] and dg1, dg2 [T] f32, in one launch. Returns the CUDA error
// code of the launch.
extern "C" int kftpu_moe_combine_backward(int dtype, const void* dout, const void* y,
                                          const void* g1, const void* g2, const void* dest1,
                                          const void* dest2, const void* slot_tok, void* dy,
                                          void* dg1, void* dg2, long long T, long long S, int M,
                                          void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || T < 1 || S < 1 || M < 8 || M % 8 != 0)
    return cudaErrorInvalidValue;
  const long long dy_blocks = blocks_for(S * (M / 8));
  const long long blocks = dy_blocks + (T + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(g1), *b = static_cast<const float*>(g2);
  const int *d1 = static_cast<const int*>(dest1), *d2 = static_cast<const int*>(dest2);
  const int* tok = static_cast<const int*>(slot_tok);
  float *o1 = static_cast<float*>(dg1), *o2 = static_cast<float*>(dg2);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dtype == kBF16) {
    using B = __nv_bfloat16;
    moe_combine_bwd<B><<<grid, kRowThreads, 0, st>>>(
        static_cast<const B*>(dout), static_cast<const B*>(y), a, b, d1, d2, tok,
        static_cast<B*>(dy), o1, o2, T, S, M, dy_blocks);
  } else {
    moe_combine_bwd<float><<<grid, kRowThreads, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(y), a, b, d1, d2, tok,
        static_cast<float*>(dy), o1, o2, T, S, M, dy_blocks);
  }
  return cudaGetLastError();
}

// K18: the gradient dl [T, E] (logits_dtype: 0 f32, 1 bf16, as the logits)
// of the routing's g1, g2 [T] and aux [G] with respect to the logits [T, E]
// (contiguous), from their cotangents dg1, dg2 [T] and daux [G] f32, the
// forward's dest1, dest2 [T] int32 and its G groups of C slots an expert.
// Returns the CUDA error code of the launch.
extern "C" int kftpu_moe_route_backward(const void* logits, int logits_dtype, long long T, int E,
                                        int G, int C, const void* dest1, const void* dest2,
                                        const void* dg1, const void* dg2, const void* daux,
                                        void* dl, void* stream) {
  if (E < 2 || E > kMaxExperts || G < 1 || C < 1 || T < G || T % G != 0 ||
      (logits_dtype != kF32 && logits_dtype != kBF16) ||
      static_cast<long long>(E) * G * C >= (1LL << 31) || T >= (1LL << 31) ||
      T / G > kMaxGroupTokens)
    return cudaErrorInvalidValue;
  const int g = static_cast<int>(T / G);
  const int trash = E * G * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int *d1 = static_cast<const int*>(dest1), *d2 = static_cast<const int*>(dest2);
  const float *a = static_cast<const float*>(dg1), *b = static_cast<const float*>(dg2);
  const float* ax = static_cast<const float*>(daux);
  if (logits_dtype == kBF16) {
    using B = __nv_bfloat16;
    return route_bwd_bound(static_cast<const B*>(logits), g, E, G, trash, d1, d2, a, b, ax,
                           static_cast<B*>(dl), st);
  }
  return route_bwd_bound(static_cast<const float*>(logits), g, E, G, trash, d1, d2, a, b, ax,
                         static_cast<float*>(dl), st);
}
