// Top-2 MoE dispatch by index for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes); see kubeflow_tpu_torch/ops/moe.py.
//
// Replaces the XLA fusions of kubeflow_tpu/parallel/moe.py's gather
// dispatch (there is no Pallas kernel behind them):
//   K12 moe_route    top2_routing (:57-114) with the index maps of
//                    _moe_dispatch_gather (:253-290);
//   K13 moe_gather   _gather_in (:159-165);
//   K14 moe_combine  _combine_out (:187-198).
// Slot s = e * G * C + q * C + c holds capacity position c of expert e in
// group q; S = E * G * C is the trash row a dropped choice points at.
//
// K12, a block a group of g tokens (T = G g), 1024 threads, on the router
// logits in f32 or in the activations' bf16 (widened exactly to f32):
//   1. a token a thread (strided): m = max_j x_j, ex_j = exp(x_j - m),
//      s = ex_0 + ex_1 + .. (left to right), gate_j = ex_j / s; e1 the
//      first argmax of the gates, e2 the first argmax with gate_e1 zeroed;
//      the group's slots zeroed;
//   2. per expert, a block scan over contiguous token chunks in token order:
//      p1 the exclusive count of earlier first choices of e1, p2 that of
//      earlier second choices of e2 plus ALL first choices of e2 (the
//      count before the capacity mask);
//   3. a token a thread: a choice at p >= C is dropped (weight 0), the
//      survivors renormalised by d = w1 + w2 (1 where d <= 0); dest the
//      slot of a choice whose weight is > 0, else S; slot_tok / slot_valid
//      set at the kept slots (distinct by construction);
//   4. aux = E sum_e (sum_t gate_te / g) (count1_e / g), the sum over e left
//      to right and over t by folding halves (zeros past g up to a power of
//      two, then x[j] += x[j + h] for h = P/2 .. 1).
// Each step is one rounded f32 operation (no contraction) in the order of
// the plain version (route_reference), so the two agree bitwise. The
// expert ids, the gates and the positions go through device memory
// between the steps (dest1/dest2 hold the ids until step 3, scratch the
// gates and positions); every thread reads them after a barrier.
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
// fraction of a microsecond at 3.35 TB/s, so a launch is its latency; K12
// at any size is one block's chain of scans and folds. The measured times
// are in PERF.md.

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kRouteThreads = 1024;
constexpr int kMaxExperts = 64;
constexpr int kRowThreads = 256;

// Exclusive prefix of v over the block's threads in thread order; every
// thread also gets the block's total. ``sums`` holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();  // an earlier scan's readers are done with ``sums``
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    sums[lane] = w;
  }
  __syncthreads();
  total = sums[warps - 1];
  return (warp > 0 ? sums[warp - 1] : 0) + inc - v;
}

// Positions of one choice (ids[t] the expert of token t) over the block's
// token chunks [lo, hi): pos[t] = offset[e] + earlier tokens with the same
// expert. ``count`` (when given) receives each expert's total.
__device__ __forceinline__ void positions(const int* ids, int* pos, int lo, int hi, int E,
                                          const int* offset, int* count, int* sums) {
  for (int e = 0; e < E; ++e) {
    int c = 0;
    for (int t = lo; t < hi; ++t) c += ids[t] == e;
    int total;
    int p = block_exclusive_scan(c, sums, total) + (offset ? offset[e] : 0);
    for (int t = lo; t < hi; ++t)
      if (ids[t] == e) pos[t] = p++;
    if (count && threadIdx.x == 0) count[e] = total;
  }
}

// L: the logits' storage type; V: slot_valid's (the activations').
template <typename L, typename V>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route(const L* __restrict__ logits, long long T, int g, int E, int G, int C,
              int* dest1, int* dest2, float* __restrict__ w1, float* __restrict__ w2,
              int* __restrict__ slot_tok, V* __restrict__ slot_valid, float* __restrict__ aux,
              float* gates, int* pos) {
  __shared__ int sums[32];
  __shared__ int count1[kMaxExperts];
  const int q = blockIdx.x;
  const long long t0 = static_cast<long long>(q) * g;
  const L* x = logits + t0 * E;
  float* gt = gates + t0 * E;
  int* ids1 = dest1 + t0;  // the expert ids until step 3
  int* ids2 = dest2 + t0;
  int* pos1 = pos + t0;
  int* pos2 = pos + T + t0;
  const long long GC = static_cast<long long>(G) * C;

  // 1. Gates and the two choices; the group's slots zeroed.
  for (int t = threadIdx.x; t < g; t += blockDim.x) {
    const L* row = x + static_cast<long long>(t) * E;
    float* gr = gt + static_cast<long long>(t) * E;
    float m = load1(row);
    for (int j = 1; j < E; ++j) m = load1(row + j) > m ? load1(row + j) : m;
    float s = 0.f;
    for (int j = 0; j < E; ++j) {
      const float ex = expf(__fsub_rn(load1(row + j), m));
      gr[j] = ex;
      s = j ? __fadd_rn(s, ex) : ex;
    }
    int i1 = 0;
    float b1 = 0.f;
    for (int j = 0; j < E; ++j) {
      const float v = __fdiv_rn(gr[j], s);
      gr[j] = v;
      if (j == 0 || v > b1) { b1 = v; i1 = j; }
    }
    int i2 = 0;
    float b2 = 0.f;
    for (int j = 0; j < E; ++j) {
      const float v = j == i1 ? 0.f : gr[j];
      if (j == 0 || v > b2) { b2 = v; i2 = j; }
    }
    ids1[t] = i1;
    ids2[t] = i2;
  }
  for (long long i = threadIdx.x; i < static_cast<long long>(E) * C; i += blockDim.x) {
    const long long s = (i / C) * GC + static_cast<long long>(q) * C + i % C;
    slot_tok[s] = 0;
    store1(slot_valid + s, 0.f);
  }
  __syncthreads();

  // 2. Positions, in token order over contiguous chunks.
  const int chunk = (g + blockDim.x - 1) / blockDim.x;
  const int lo = min(g, static_cast<int>(threadIdx.x) * chunk);
  const int hi = min(g, lo + chunk);
  positions(ids1, pos1, lo, hi, E, nullptr, count1, sums);
  __syncthreads();
  positions(ids2, pos2, lo, hi, E, count1, nullptr, sums);
  __syncthreads();

  // 3. Capacity, weights and the index maps.
  const long long trash = static_cast<long long>(E) * GC;
  for (int t = threadIdx.x; t < g; t += blockDim.x) {
    const int i1 = ids1[t], i2 = ids2[t];
    const int p1 = pos1[t], p2 = pos2[t];
    const float* gr = gt + static_cast<long long>(t) * E;
    const float a = p1 < C ? gr[i1] : 0.f;
    const float b = p2 < C ? gr[i2] : 0.f;
    float d = __fadd_rn(a, b);
    d = d > 0.f ? d : 1.f;
    const float x1 = __fdiv_rn(a, d), x2 = __fdiv_rn(b, d);
    const long long tok = t0 + t;
    const long long s1 = x1 > 0.f ? i1 * GC + static_cast<long long>(q) * C + p1 : trash;
    const long long s2 = x2 > 0.f ? i2 * GC + static_cast<long long>(q) * C + p2 : trash;
    w1[tok] = x1;
    w2[tok] = x2;
    ids1[t] = static_cast<int>(s1);  // dest1[tok]: this thread alone reads ids1[t]
    ids2[t] = static_cast<int>(s2);
    if (s1 < trash) {
      slot_tok[s1] = static_cast<int>(tok);
      store1(slot_valid + s1, 1.f);
    }
    if (s2 < trash) {
      slot_tok[s2] = static_cast<int>(tok);
      store1(slot_valid + s2, 1.f);
    }
  }
  __syncthreads();

  // 4. The aux loss: the gates' sums over the tokens by folding halves.
  int P = 1;
  while (P < g) P <<= 1;
  for (int h = P / 2; h >= 1; h /= 2) {
    for (long long i = threadIdx.x; i < static_cast<long long>(h) * E; i += blockDim.x) {
      const long long j = i / E, e = i % E;
      if (j + h < g) gt[j * E + e] = __fadd_rn(gt[j * E + e], gt[(j + h) * E + e]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(g);
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const float me = __fdiv_rn(gt[e], n);
      const float ce = __fdiv_rn(static_cast<float>(count1[e]), n);
      const float p = __fmul_rn(me, ce);
      acc = e ? __fadd_rn(acc, p) : p;
    }
    aux[q] = __fmul_rn(acc, static_cast<float>(E));
  }
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

}  // namespace

// K12: routing of logits [T, E] (contiguous; logits_dtype and valid_dtype:
// 0 f32, 1 bf16) in G groups of T / G tokens, C slots an expert a group.
// Writes dest1, dest2 [T] int32, w1, w2 [T] f32, slot_tok [E G C] int32,
// slot_valid [E G C], aux [G] f32; gates [T E] f32 and pos [2 T] int32 are
// scratch. Returns the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_moe_route(const void* logits, int logits_dtype, long long T, int E, int G,
                               int C, int valid_dtype, void* dest1, void* dest2, void* w1,
                               void* w2, void* slot_tok, void* slot_valid, void* aux,
                               void* gates, void* pos, void* stream) {
  if (E < 2 || E > kMaxExperts || G < 1 || C < 1 || T < G || T % G != 0 ||
      (valid_dtype != kF32 && valid_dtype != kBF16) ||
      (logits_dtype != kF32 && logits_dtype != kBF16) ||
      static_cast<long long>(E) * G * C >= (1LL << 31) || T >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int g = static_cast<int>(T / G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int *d1 = static_cast<int*>(dest1), *d2 = static_cast<int*>(dest2);
  float *a = static_cast<float*>(w1), *b = static_cast<float*>(w2);
  int* tok = static_cast<int*>(slot_tok);
  float* ax = static_cast<float*>(aux);
  float* gt = static_cast<float*>(gates);
  int* ps = static_cast<int*>(pos);
  auto launch = [&](auto* lg) {
    if (valid_dtype == kBF16) {
      moe_route<<<G, kRouteThreads, 0, st>>>(lg, T, g, E, G, C, d1, d2, a, b, tok,
                                             static_cast<__nv_bfloat16*>(slot_valid), ax, gt, ps);
    } else {
      moe_route<<<G, kRouteThreads, 0, st>>>(lg, T, g, E, G, C, d1, d2, a, b, tok,
                                             static_cast<float*>(slot_valid), ax, gt, ps);
    }
  };
  if (logits_dtype == kBF16) {
    launch(static_cast<const __nv_bfloat16*>(logits));
  } else {
    launch(static_cast<const float*>(logits));
  }
  return cudaGetLastError();
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
