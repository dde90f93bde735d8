// Decode attention for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes); see kubeflow_tpu_torch/ops/decode_attention.py.
//
// Replaces the XLA-fused decode attention of the JAX model,
// kubeflow_tpu/models/llama.py::Attention._decode_attention (the masked
// mha_reference over the dense cache, int8 scales included) and
// _staged_decode_attention (one softmax over the flushed cache and the
// chunk's staging rows). There is no Pallas kernel behind it: on the TPU,
// XLA fuses the cache's dtype convert into the two einsums.
//
// Function: one query row per (slot, head), Sq == 1. Every query head of
// a kv head (G = H / Hkv) is served by one pass over that kv head's rows.
// Slot b sees cache rows [0, min(lengths[b], L)) and, when staged, staging
// rows [0, stage_rows). Logits are f32 (exact products of bf16 q and k,
// summed in f32), times scale and, for an int8 cache, k's row scale; the
// softmax is f32; each weight is multiplied by v's row scale (int8 cache)
// and rounded to bf16 before its product with v, as mha_reference rounds
// the weights to the activation dtype; products accumulate in f32; o is
// written in bf16. The weight that is rounded is the online softmax's
// unnormalised one (relative to the running max); the sum divides at the
// end.
//
// Bound on this card: bytes. Per kv row and kv head it reads D k and D v
// values (2 bytes each in bf16, 1 in int8, plus two f32 scales) and does
// 4 G D flops: at G = 4 that is 8 flops a byte (bf16), far below the ~295
// at which the tensor cores would set the pace. The design spends its
// effort on bytes in flight, and on keeping the instructions a row costs
// below what the bytes allow:
// - One launch a call. The blocks of one (slot, kv head) form a thread
//   block cluster (at most 8 blocks, the portable size, and no more than
//   a full cache has 16-row chunks); grid (cluster, Hkv, B). The size is
//   the largest at which all B x Hkv clusters are resident at once (the
//   card's occupancy answer), so it depends on the shapes alone and one
//   captured CUDA graph serves every length.
// - The split is made on the device from the slot's length: the live rows,
//   in 16-row chunks, are shared evenly over the cluster's blocks (the
//   first blocks take one chunk more); the last block also takes the
//   staging rows.
// - One producer warp issues TMA loads (4-D tensor maps over the cache
//   [B, L, Hkv, D] and the staging rows [B, C, Hkv, D], boxes of 16 rows,
//   swizzled) of the block's chunks into a ring of ~56 KB of shared-memory
//   stages (3 blocks an SM), completed on mbarriers; an int8 chunk's 32
//   row scales come with it as 4-byte cp.async copies tracked by the same
//   mbarrier. At L = 1024 a block's whole share is in flight at once
//   (the first staging chunk in a buffer of its own). Producer and
//   consumers derive the same chunk count from the same length; rows past
//   the live length (TMA zero-fills rows past L, which would give logit 0)
//   are masked.
// - Four consumer warps; stage s belongs to warp s % 4. A chunk's logits
//   for the G query heads and its weighted v rows are warp-wide mma.sync
//   products (m16n8k16, bf16 operands, f32 accumulators), transposed so
//   the 16 cache rows or 16 D columns fill the tile's rows and the query
//   heads are its 8 columns: bf16 x bf16 products are exact in f32, as
//   the f32 FMAs of a plain loop are, and int8 values are exact in bf16,
//   so only the order of the f32 sums differs from such a loop. (An FMA
//   version of this kernel took 11.5 us at the served shape, 6.5 with its
//   arithmetic removed: the FMAs, shuffles and the softmax that every
//   lane of a row repeated; PERF.md.) An int8 chunk is converted in
//   registers: k in a permuted order along D (q is permuted the same way),
//   v through ldmatrix in byte pairs, which permutes the output columns
//   (undone when the accumulators are stored).
// - The warps' states merge through shared memory (the drained ring) into
//   the block's, whose accumulators go straight to the blocks that merge
//   them: every block of the cluster owns a slice of the G x D outputs, and
//   after one cluster barrier merges its slice over the cluster's blocks
//   in rank order and writes o. Nothing goes through device memory but q,
//   the rows, the lengths and o, and the fixed merge order keeps two calls
//   bitwise equal.
// - Paged mode (kftpu_decode_attention_paged): k and v (and the int8
//   scales) are one pool [P + 1, bs, Hkv, D] shared by every slot, and slot
//   b's logical row r lives at pool row (table[b, r / bs], r % bs). The
//   tensor maps cover the pool as pages (D, bs, Hkv, P + 1), so a chunk's
//   TMA coordinate (row0, b) becomes (row0 % bs, table[b, row0 / bs]); with
//   bs a multiple of 16 a 16-row box never straddles two pages. The
//   producer warp holds 32 table entries in its lanes (one coalesced load
//   of pages 0..31 at the kernel's start, refilled every 32 pages) and
//   takes each chunk's page by a shuffle, the row in the page advancing
//   16 rows a chunk. Paged is a template parameter, so the dense
//   instantiations run exactly their own code (32 kernels in all), and
//   both take the cluster size the dense one's occupancy gives. The logical length
//   max_blocks x bs sets the split, so a paged call and a dense call over
//   the same rows run the same chunks in the same order and are bitwise
//   equal. Rows past the live length (another sequence's, the scratch
//   page's) stay behind the same mask.
// Capture-safe: lengths and tables are read on the device, nothing is
// allocated, and the kernel goes on the caller's stream.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kRows = 16;                   // cache rows per chunk (TMA box)
constexpr int kRingBytes = 56 * 1024;       // 3 blocks an SM
constexpr int kMaxCluster = 8;
constexpr float kNegInf = flash::kNegInf;   // finite: empty blocks merge to weight 0
constexpr float kLog2e = flash::kLog2e;

struct Params {
  CUtensorMap tm_k;                 // cache [B, L, Hkv, D] as (D, L, Hkv, B), 16-row boxes
  CUtensorMap tm_v;
  CUtensorMap tm_sk;                // staging [B, C, Hkv, D] bf16 (staged calls)
  CUtensorMap tm_sv;
  const __nv_bfloat16* q;           // [B, 1, H, D] via q_sb, q_sh
  const float* k_scale;             // [B, L, Hkv, 1] f32 (int8 cache)
  const float* v_scale;
  const int* lengths;               // [B] int32: live cache rows
  const int* tables;                // paged: [B, max_blocks] int32 page ids; dense: null
  __nv_bfloat16* o;                 // [B, H, D] contiguous
  int stage_rows;                   // staging rows live (stage_step + 1), 0 = unstaged
  int H, L;                         // L: logical rows (paged: max_blocks x bs)
  int bs, max_blocks, pages;        // paged: rows a page, table width, pool pages (P + 1)
  long long q_sb, q_sh, s_sb, s_ss, s_sh;
  float scale_log2;                 // D^-0.5 * log2(e): the softmax runs in base 2
};

// A chunk's k (or v) rows in shared memory as TMA writes them: bf16 as
// D / 64 boxes of 16 rows x 64 columns, int8 as one box of 16 rows x D
// bytes. Rows of 128 bytes carry the 128-byte swizzle (16-byte chunk c of
// row r lands at c ^ (r % 8)), int8 rows of 64 bytes the 64-byte one
// (c ^ (r / 2 % 4)), so the 8 rows an ldmatrix or a fragment load reads
// fall in distinct banks.
template <int D, bool INT8>
struct Tile {
  static constexpr int kBox = kRows * (INT8 ? D : 128);
  static constexpr int kBytes = kRows * D * (INT8 ? 1 : 2);
  // Byte offset of the row's 16-byte chunk c (counted along D).
  __device__ static __forceinline__ int offset(int r, int c) {
    if (INT8) return r * D + ((c ^ (D == 128 ? r & 7 : (r >> 1) & 3)) << 4);
    return (c >> 3) * kBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
};

template <int D, int G, bool INT8>
struct Cfg {
  using KV = Tile<D, INT8>;
  using ST = Tile<D, false>;                               // staging rows are bf16
  static constexpr int kStage = 2 * KV::kBytes;            // k, then v
  static constexpr int kStages = kRingBytes / kStage;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStaging = 2 * ST::kBytes;
  static constexpr int kScales = INT8 ? kStages * 2 * kRows * 4 : 0;
  // What the cluster's blocks send this block: the accumulators of its
  // slice of the G x D outputs from each block, then each block's m[G], l[G].
  static constexpr int kInboxAcc = G * D + kMaxCluster;
  static constexpr int kInbox = (kInboxAcc + kMaxCluster * 2 * G) * 4;
  // A warp's state in shared memory: acc[G][D + 4] (the pad spreads the
  // lanes' stores over the banks), m[G], l[G].
  static constexpr int kAccRow = D + 4;
  static constexpr int kPart = G * kAccRow + 2 * G;
  static constexpr int kSmem = 1024 + kRing + kStaging + kScales + kInbox + (2 * kStages + 2) * 8;
  static_assert(G <= 8, "the query heads are the 8 columns of an mma tile");
  static_assert(kConsumerWarps * kPart * 4 <= kRing, "the warps' partials fit the ring");
  static_assert(KV::kBytes % 1024 == 0, "swizzled TMA boxes stay 1024-byte aligned");
  static_assert(kStages >= kConsumerWarps, "every warp owns a stage");
};

// ---- fragments -------------------------------------------------------------
//
// Both products run transposed, so the 16 rows of each mma tile are fully
// used and the query heads (at most 8) are its columns: S = K q^T (A: 16
// cache rows x 16 D columns, B: q^T, 16 D columns x 8 heads) and
// O^T = V^T P^T (A: 16 D columns x 16 cache rows, B: P^T, 16 rows x 8
// heads). A lane of quad t (t = lane % 4) holds heads 2t and 2t + 1.

// d[4] += A (16 x 16 bf16) * B (16 x 8 bf16), f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The 8 x 8 bf16 matrix whose row lane / 4, columns 2t and 2t + 1 this lane
// holds, transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// bf16x2 of two int8 bytes (lo, hi) of a word whose bytes were flipped to
// x + 128: each lands in the low mantissa byte of 1.5 * 2^23, and the
// float minus (1.5 * 2^23 + 128) is x exactly (exact in bf16 too).
template <int LO, int HI>
__device__ __forceinline__ uint32_t int8_pair(uint32_t flipped) {
  const float lo = __uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7640u | LO)) - 12583040.f;
  const float hi = __uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7640u | HI)) - 12583040.f;
  return flash::pack_bf16(lo, hi);
}

// The A fragments of K (16 rows x 16 D columns) for the four k-steps
// 4 g .. 4 g + 3: in k-step 4 g + i the lane's k slots 2t, 2t + 1, 2t + 8,
// 2t + 9 take D columns 64 g + 16 t + 4 i .. + 3 (q^T's B fragments are
// permuted alike), so a lane reads 16 consecutive columns of each of rows
// lane / 4 and lane / 4 + 8 with 16-byte loads.
template <int D, bool INT8>
__device__ __forceinline__ void k_frags(uint32_t tile, int g, int lane, uint32_t (&a)[4][4]) {
  using T = Tile<D, INT8>;
  const int n = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (INT8) {
      const uint4 w = lds128(tile + T::offset(n + 8 * h, 4 * g + t));
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t f = words[i] ^ 0x80808080u;
        a[i][h] = int8_pair<0, 1>(f);
        a[i][2 + h] = int8_pair<2, 3>(f);
      }
    } else {
      const uint4 lo = lds128(tile + T::offset(n + 8 * h, 8 * g + 2 * t));
      const uint4 hi = lds128(tile + T::offset(n + 8 * h, 8 * g + 2 * t + 1));
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][h] = words[2 * i];
        a[i][2 + h] = words[2 * i + 1];
      }
    }
  }
}

// The D column of row m (0..15) of output tile j: v's columns in order for
// a bf16 cache; for an int8 one, each ldmatrix of byte pairs splits 32
// columns into even (tile 2q) and odd (tile 2q + 1) ones.
template <bool INT8>
__device__ __forceinline__ int out_col(int j, int m) {
  return INT8 ? 32 * (j >> 1) + 2 * m + (j & 1) : 16 * j + m;
}

// A warp's online softmax for the two heads of its lane quad (heads >= G
// see zero q and are ignored): running max, the lane's share of the sum,
// and the lane's four accumulators (rows lane / 4 and + 8; heads 2t, 2t + 1)
// of each of the D / 16 output tiles.
template <int D>
struct State {
  float m[2], l[2], o[D / 16][4];
};

// One chunk into the warp's state. TILE_INT8: the chunk is int8 cache rows
// with their scales (else bf16 rows); INT8: the kernel's cache, which sets
// the output column order. `live` rows of the 16 count.
template <int D, bool INT8, bool TILE_INT8>
__device__ __forceinline__ void attend_chunk(State<D>& st, const uint32_t (&qb)[D / 16][2],
                                             uint32_t kt, uint32_t vt, const float* scales,
                                             int live, float scale_log2, int lane) {
  const int n = lane >> 2;
  // S (16 rows x 8 heads): this lane's rows n, n + 8, heads 2t, 2t + 1;
  // even and odd k-steps in two accumulators, two chains of products.
  float s[4] = {0.f, 0.f, 0.f, 0.f}, s_odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < D / 64; ++g) {
    uint32_t a[4][4];
    k_frags<D, TILE_INT8>(kt, g, lane, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mma_16816(i % 2 ? s_odd : s, a[i], qb[4 * g + i][0], qb[4 * g + i][1]);
    }
  }
  bool valid[2];
  float x[2][2], vsc[2];                 // [row half][head]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    valid[h] = n + 8 * h < live;
    // A masked row's stale scale may be anything: it is never read.
    const float ksc = TILE_INT8 && valid[h] ? scales[n + 8 * h] : 1.f;
    vsc[h] = TILE_INT8 && valid[h] ? scales[kRows + n + 8 * h] : 1.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) x[h][e] = (s[2 * h + e] + s_odd[2 * h + e]) * scale_log2 * ksc;
  }
  float w[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {          // head 2t + e
    float mx = st.m[e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (valid[h]) mx = fmaxf(mx, x[h][e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    if (mx > st.m[e]) {                  // uniform over the head's lanes
      const float corr = fast_exp2(st.m[e] - mx);
      st.l[e] *= corr;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        st.o[j][e] *= corr;
        st.o[j][2 + e] *= corr;
      }
      st.m[e] = mx;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float pr = valid[h] ? fast_exp2(x[h][e] - mx) : 0.f;
      st.l[e] += pr;
      w[h][e] = pr * vsc[h];
    }
  }
  // P^T's B fragment: the weights, rounded to bf16, transposed so the lane
  // holds rows 2t, 2t + 1 (and + 8) of head n.
  uint32_t wp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) wp[h] = movmatrix_trans(flash::pack_bf16(w[h][0], w[h][1]));

  const int mat = lane >> 3;             // ldmatrix: lane's matrix and row
  const int lrow = (mat >> 1) * 8 + (lane & 7);
  if (!INT8) {
    using T = Tile<D, false>;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t a[4];
      ldsm_x4_trans(a, vt + T::offset(lrow, 2 * j + (mat & 1)));
      mma_16816(st.o[j], a, wp[0], wp[1]);
    }
  } else if (TILE_INT8) {
    using T = Tile<D, true>;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      uint32_t r[4];                     // byte pairs of two adjacent D columns
      ldsm_x4_trans(r, vt + T::offset(lrow, 2 * q + (mat & 1)));
      uint32_t even[4], odd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t f = r[i] ^ 0x80808080u;
        even[i] = int8_pair<0, 2>(f);
        odd[i] = int8_pair<1, 3>(f);
      }
      mma_16816(st.o[2 * q], even, wp[0], wp[1]);
      mma_16816(st.o[2 * q + 1], odd, wp[0], wp[1]);
    }
  } else {
    // bf16 staging rows in the int8 kernel's column order: a 4-byte load
    // holds columns 2c and 2c + 1 of a row, i.e. this lane's value in the
    // even and in the odd tile of a pair.
    using T = Tile<D, false>;
    const int t = lane & 3;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      uint32_t even[4], odd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {      // a0..a3: column pair c = 16q + n (+ 8), rows 2t (+ 8)
        const int c = 16 * q + n + 8 * (i & 1), r = 2 * t + 8 * (i >> 1);
        const uint32_t at = vt + 4 * (c & 3);
        const uint32_t lo = lds32(at + T::offset(r, c >> 2));
        const uint32_t hi = lds32(at + T::offset(r + 1, c >> 2));
        even[i] = __byte_perm(lo, hi, 0x5410);
        odd[i] = __byte_perm(lo, hi, 0x7632);
      }
      mma_16816(st.o[2 * q], even, wp[0], wp[1]);
      mma_16816(st.o[2 * q + 1], odd, wp[0], wp[1]);
    }
  }
}

// 4 bytes global -> shared, completion tracked by the next cp_async_arrive.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The cluster barrier in two halves: this thread's arrival (ordering
// nothing), and the wait for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The barrier's current phase also waits for this thread's earlier
// cp.async copies (the pending count rises now and falls when they land).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

template <int D, int G, bool INT8, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_attn(const __grid_constant__ Params p) {
  using C = Cfg<D, G, INT8>;
  using KV = typename C::KV;
  using ST = typename C::ST;
  extern __shared__ uint8_t smem_raw[];
  // Aligned by an offset from the array, so every pointer below stays a
  // shared-memory one (32-bit addresses, LDS/STS rather than generic loads).
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + C::kRing;
  float* scales = reinterpret_cast<float*>(staging + C::kStaging);   // [stage][k 16, v 16]
  float* inbox = reinterpret_cast<float*>(staging + C::kStaging + C::kScales);
  float* inbox_ml = inbox + C::kInboxAcc;                            // [block][m[G], l[G]]
  uint64_t* full = reinterpret_cast<uint64_t*>(inbox + C::kInbox / 4);
  uint64_t* empty = full + C::kStages;
  uint64_t* st_full = empty + C::kStages;
  uint64_t* st_empty = st_full + 1;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Paged: lane j of the producer holds the page of logical block
  // win0 + j. The first window (blocks 0..31) is read first of all, so no
  // chunk's TMA coordinate waits for it after the split.
  const int* table = p.tables + static_cast<long long>(b) * p.max_blocks;
  int win0 = 0, win = 0;
  auto load_window = [&](int first) {
    win0 = first;
    const int j = min(first + lane, p.max_blocks - 1);
    win = min(max(__ldg(table + j), 0), p.pages - 1);   // a bad id still reads inside the pool
  };
  if (PAGED && warp == kConsumerWarps) load_window(0);

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(st_full, 1);
    mbar_init(st_empty, 1);
    mbar_fence_init();
  }
  cluster_arrive_relaxed();               // this block runs; waited for before the first send

  // q^T's B fragments (consumers), in flight beside the length read: head
  // g = lane / 4 (zero for g >= G); k-step ks takes D columns
  // 64 (ks / 4) + 16 t + 4 (ks % 4) .. + 3, as k_frags.
  uint32_t qb[D / 16][2];
  if (warp < kConsumerWarps) {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        p.q + b * p.q_sb + (hk * G + (g < G ? g : 0)) * p.q_sh);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      uint4 w[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (g < G) {
        w[0] = __ldg(reinterpret_cast<const uint4*>(qr + 32 * c + 8 * t));
        w[1] = __ldg(reinterpret_cast<const uint4*>(qr + 32 * c + 8 * t + 4));
      }
      const uint32_t words[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qb[4 * c + i][0] = words[2 * i];
        qb[4 * c + i][1] = words[2 * i + 1];
      }
    }
  }

  // This block's share of the live rows: chunks [c0, c0 + count) of the
  // slot's ceil(n / 16); producer and consumers derive the same count.
  const int n = min(max(p.lengths[b], 0), p.L);
  const int chunks = (n + kRows - 1) / kRows;
  const int per = chunks / blocks, extra = chunks % blocks;
  const int c0 = rank * per + min(rank, extra);
  const int count = per + (rank < extra ? 1 : 0);
  const int stage_rows = rank == blocks - 1 ? p.stage_rows : 0;
  const int stage_chunks = (stage_rows + kRows - 1) / kRows;
  __syncthreads();                                             // barriers initialised

  if (warp == kConsumerWarps) {
    // Producer: the first staging chunk, then every chunk of the share as
    // soon as its stage is free (up to kStages in flight), then any
    // further staging chunks, in the order the consumer warps take them.
    if (lane == 0) {
      prefetch_tensor_map(&p.tm_k);
      prefetch_tensor_map(&p.tm_v);
      if (stage_rows > 0) {
        prefetch_tensor_map(&p.tm_sk);
        prefetch_tensor_map(&p.tm_sv);
      }
    }
    auto issue_staging = [&](int j) {
      mbar_wait(st_empty, (j & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(st_full, 2 * ST::kBytes);
#pragma unroll
        for (int box = 0; box < D / 64; ++box) {
          tma_load_4d(staging + box * ST::kBox, &p.tm_sk, st_full, 64 * box, kRows * j, hk, b);
          tma_load_4d(staging + ST::kBytes + box * ST::kBox, &p.tm_sv, st_full, 64 * box,
                      kRows * j, hk, b);
        }
      }
    };
    if (stage_chunks > 0) issue_staging(0);
    // Paged: the chunk's logical block and its first row in the page,
    // advanced 16 rows a chunk.
    int lb = 0, in_page = 0;
    if (PAGED) {
      lb = c0 * kRows / p.bs;
      in_page = c0 * kRows - lb * p.bs;
    }
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      const int s = i % C::kStages;
      mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);        // a fresh stage passes at once
      uint8_t* stage = smem + s * C::kStage;
      const int row0 = (c0 + i) * kRows;
      // The chunk's (row, batch) coordinate: (row0, b) in the dense cache,
      // (row0 % bs, its page) in the pool.
      int r0 = row0, blk = b;
      if (PAGED) {
        if (lb - win0 >= 32) load_window(lb);                  // uniform over the warp
        blk = __shfl_sync(0xffffffffu, win, lb - win0);
        r0 = in_page;
        in_page += kRows;
        if (in_page == p.bs) {
          in_page = 0;
          ++lb;
        }
      }
      if (INT8) {
        // Lanes 0..15 copy k's scale of row row0 + lane, lanes 16..31 v's.
        if (row0 + lane % kRows < n) {
          const float* src = (lane < kRows ? p.k_scale : p.v_scale) +
                             static_cast<long long>(blk) * p.s_sb +
                             (r0 + lane % kRows) * p.s_ss + hk * p.s_sh;
          cp_async_4(scales + s * 2 * kRows + lane, src);
        }
        cp_async_arrive(&full[s]);
        __syncwarp();                      // every lane's copies counted before the TMA arrive
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], C::kStage);
#pragma unroll
        for (int box = 0; box < (INT8 ? 1 : D / 64); ++box) {
          tma_load_4d(stage + box * KV::kBox, &p.tm_k, &full[s], 64 * box, r0, hk, blk);
          tma_load_4d(stage + KV::kBytes + box * KV::kBox, &p.tm_v, &full[s], 64 * box, r0, hk,
                      blk);
        }
      }
    }
#pragma unroll 1
    for (int j = 1; j < stage_chunks; ++j) issue_staging(j);
  } else {
    State<D> st;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
    const uint32_t staging_u32 = smem_u32(staging), ring_u32 = smem_u32(smem);
    // The last warp also takes the staging chunks: the first before its
    // share of the ring, the rest after.
    const bool stager = warp == kConsumerWarps - 1;
    auto staging_chunk = [&](int j) {
      mbar_wait(st_full, j & 1);
      attend_chunk<D, INT8, false>(st, qb, staging_u32, staging_u32 + ST::kBytes, nullptr,
                                   min(stage_rows - kRows * j, kRows), p.scale_log2, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(st_empty);
    };
    if (stager && stage_chunks > 0) staging_chunk(0);
    // Stage s belongs to warp s % 4, so a warp waits on its stages' phases
    // in order (a parity wait cannot tell a phase from the one two ahead).
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      const int s = i % C::kStages;
      if (s % kConsumerWarps != warp) continue;
      mbar_wait(&full[s], (i / C::kStages) & 1);
      const uint32_t stage = ring_u32 + s * C::kStage;
      attend_chunk<D, INT8, INT8>(st, qb, stage, stage + KV::kBytes, scales + s * 2 * kRows,
                                  n - (c0 + i) * kRows, p.scale_log2, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);                  // the stage may be refilled
    }
    if (stager) {
#pragma unroll 1
      for (int j = 1; j < stage_chunks; ++j) staging_chunk(j);
    }

    // Each head's sum over the lanes of its rows; then the warp's state
    // goes over the drained ring.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) st.l[c] += __shfl_xor_sync(0xffffffffu, st.l[c], off);
    }
    named_bar_sync(1, kConsumers);                             // every stage read
    const int m = lane >> 2, t = lane & 3;
    float* part = reinterpret_cast<float*>(smem) + warp * C::kPart;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = 2 * t + c;
      if (g < G) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          part[g * C::kAccRow + out_col<INT8>(j, m)] = st.o[j][c];
          part[g * C::kAccRow + out_col<INT8>(j, m + 8)] = st.o[j][2 + c];
        }
        if (m == 0) {
          part[G * C::kAccRow + g] = st.m[c];
          part[G * C::kAccRow + G + g] = st.l[c];
        }
      }
    }
  }
  __syncthreads();

  // The block's (m, l, acc), its warps in order, goes straight to the
  // blocks that merge it: output idx belongs to the block whose slice
  // [r G D / blocks, (r + 1) G D / blocks) holds it.
  const float* parts = reinterpret_cast<const float*>(smem);
  const float* parts_ml = parts + G * C::kAccRow;
  const int slice = (G * D + blocks - 1) / blocks;
  cluster_wait();                         // every block of the cluster runs
#pragma unroll
  for (int u = 0; u < (G * D + kThreads - 1) / kThreads; ++u) {
    const int idx = tid + u * kThreads;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, parts_ml[w * C::kPart + g]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float e = fast_exp2(parts_ml[w * C::kPart + g] - mx);
        a = fmaf(parts[w * C::kPart + g * C::kAccRow + d], e, a);
        ls = fmaf(parts_ml[w * C::kPart + G + g], e, ls);
      }
      const int owner = ((idx + 1) * blocks - 1) / (G * D);
      cluster.map_shared_rank(inbox, owner)[rank * slice + idx - owner * G * D / blocks] = a;
      if (d == 0) {
        for (int j = 0; j < blocks; ++j) {
          float* ml = cluster.map_shared_rank(inbox_ml, j) + rank * 2 * G;
          ml[g] = mx;
          ml[G + g] = ls;
        }
      }
    }
  }
  cluster.sync();                         // every block's sends have landed

  // This block's slice of the outputs: the blocks' accumulators merged in
  // rank order, o written. Nothing reads this block's shared memory now.
  const int lo = rank * G * D / blocks, hi = (rank + 1) * G * D / blocks;
  for (int idx = lo + tid; idx < hi; idx += kThreads) {
    const int g = idx / D;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < blocks) mx = fmaxf(mx, inbox_ml[j * 2 * G + g]);
    }
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < blocks) {
        const float e = fast_exp2(inbox_ml[j * 2 * G + g] - mx);
        a = fmaf(inbox[j * slice + idx - lo], e, a);
        ls = fmaf(inbox_ml[j * 2 * G + G + g], e, ls);
      }
    }
    // No live row at all (mha_reference's fully masked row): o = 0.
    p.o[(static_cast<long long>(b) * p.H + hk * G) * D + idx] =
        __float2bfloat16(ls > 0.f ? a / ls : 0.f);
  }
}

// The tensor map of an int8 cache [B, L, Hkv, D] (strides in elements,
// head dim contiguous) as (D, L, Hkv, B), read in boxes of D bytes x kRows
// rows of one head with the swizzle of Tile<D, true>. (A bf16 cache takes
// hopper::encode_bshd_bf16: boxes of 64 columns.) False when
// cuTensorMapEncodeTiled refuses it.
bool encode_int8_cache(CUtensorMap* map, const void* ptr, int B, int L, int Hkv, int D,
                       long long ss, long long sh, long long sb) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(Hkv), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss), static_cast<cuuint64_t>(sh),
                                 static_cast<cuuint64_t>(sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  const void* k;
  const void* v;
  const void* sk;
  const void* sv;
  int B, Hkv, cluster, stage_len;
  int map_b, map_rows;              // the cache maps' outer dims: (B, L), or (P + 1, bs) paged
  long long c_sb, c_ss, c_sh, st_sb, st_ss, st_sh;
};

// A launch of ``cluster``-block clusters over a grid of ``grid`` clusters.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int cluster, dim3 grid, int smem, cudaStream_t st) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster * grid.x, grid.y, grid.z);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The largest cluster of at most ``want`` blocks of which ``pairs``
// clusters are resident at once (one wave), else 1: a cluster waits for
// room for all its blocks on one GPC, so a second wave costs a whole
// cluster's time. The card's answer is asked once per device and size.
template <class Kernel>
cudaError_t fit_cluster(Kernel kernel, int smem, int want, int pairs, int* cluster) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices][kMaxCluster + 1] = {};   // 0: not asked yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int c = want; c > 1; --c) {
    int n = device < kMaxDevices ? resident[device][c] : 0;
    if (n == 0) {
      ClusterLaunch l(c, dim3(1), smem, nullptr);
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
      if (err != cudaSuccess) return err;
      n = n > 0 ? n : -1;
      if (device < kMaxDevices) resident[device][c] = n;
    }
    if (n >= pairs) {
      *cluster = c;
      return cudaSuccess;
    }
  }
  *cluster = 1;
  return cudaSuccess;
}

// Opts both kernels of (D, G, INT8) in to their shared memory and picks the
// cluster size from the dense one's occupancy: a paged call and a dense call
// over the same rows split them alike, so they are bitwise equal.
template <int D, int G, bool INT8>
cudaError_t plan(int want, int pairs, int* cluster) {
  using C = Cfg<D, G, INT8>;
  static bool smem_set = false, paged_smem_set = false;
  cudaError_t err = flash::allow_smem(decode_attn<D, G, INT8, false>, C::kSmem, smem_set);
  if (err == cudaSuccess) {
    err = flash::allow_smem(decode_attn<D, G, INT8, true>, C::kSmem, paged_smem_set);
  }
  if (err != cudaSuccess) return err;
  return fit_cluster(decode_attn<D, G, INT8, false>, C::kSmem, want, pairs, cluster);
}

template <int D, int G, bool INT8>
cudaError_t launch(Params& p, const Launch& a, cudaStream_t st) {
  int cluster = 1;
  cudaError_t err = plan<D, G, INT8>(a.cluster, a.B * a.Hkv, &cluster);
  if (err != cudaSuccess) return err;
  const bool maps =
      (INT8 ? encode_int8_cache(&p.tm_k, a.k, a.map_b, a.map_rows, a.Hkv, D, a.c_ss, a.c_sh,
                                a.c_sb) &&
                  encode_int8_cache(&p.tm_v, a.v, a.map_b, a.map_rows, a.Hkv, D, a.c_ss, a.c_sh,
                                    a.c_sb)
            : encode_bshd_bf16(&p.tm_k, a.k, a.map_b, a.map_rows, a.Hkv, D, a.c_ss, a.c_sh,
                               a.c_sb, kRows) &&
                  encode_bshd_bf16(&p.tm_v, a.v, a.map_b, a.map_rows, a.Hkv, D, a.c_ss, a.c_sh,
                                   a.c_sb, kRows)) &&
      (p.stage_rows == 0 ||
       (encode_bshd_bf16(&p.tm_sk, a.sk, a.B, a.stage_len, a.Hkv, D, a.st_ss, a.st_sh, a.st_sb,
                         kRows) &&
        encode_bshd_bf16(&p.tm_sv, a.sv, a.B, a.stage_len, a.Hkv, D, a.st_ss, a.st_sh, a.st_sb,
                         kRows)));
  if (!maps) return cudaErrorInvalidValue;
  ClusterLaunch l(cluster, dim3(1, a.Hkv, a.B), Cfg<D, G, INT8>::kSmem, st);
  err = p.tables != nullptr ? cudaLaunchKernelEx(&l.cfg, decode_attn<D, G, INT8, true>, p)
                            : cudaLaunchKernelEx(&l.cfg, decode_attn<D, G, INT8, false>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V>
using Int = std::integral_constant<int, V>;

// fn(Int<D>, Int<G>, std::bool_constant<INT8>) for the instantiation that
// serves (head_dim, group, int8).
template <class Fn>
cudaError_t dispatch(int head_dim, int group, int int8, Fn&& fn) {
  auto by_group = [&](auto d, auto i) -> cudaError_t {
    switch (group) {
      case 1: return fn(d, Int<1>{}, i);
      case 2: return fn(d, Int<2>{}, i);
      case 4: return fn(d, Int<4>{}, i);
      case 8: return fn(d, Int<8>{}, i);
      default: return cudaErrorInvalidValue;
    }
  };
  if (head_dim == 128) {
    return int8 ? by_group(Int<128>{}, std::true_type{}) : by_group(Int<128>{}, std::false_type{});
  }
  if (head_dim == 64) {
    return int8 ? by_group(Int<64>{}, std::true_type{}) : by_group(Int<64>{}, std::false_type{});
  }
  return cudaErrorInvalidValue;
}

// The launch behind both C entries; ``tables`` null for the dense cache.
int decode_attention_impl(int head_dim, int group, int kv_int8, const void* q, const void* k,
                          const void* v, const void* k_scale, const void* v_scale,
                          const void* lengths, const void* tables, int max_blocks, int block_size,
                          int pages, const void* stage_k, const void* stage_v, int stage_rows,
                          int stage_len, void* o, int B, int Hkv, int L, int cluster,
                          const long long* strides, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || L <= 0 || cluster < 1 || cluster > kMaxCluster || stage_rows < 0 ||
      stage_rows > stage_len) {
    return cudaErrorInvalidValue;
  }
  Params p;
  memset(&p, 0, sizeof(p));
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.tables = static_cast<const int*>(tables);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.stage_rows = stage_rows;
  p.H = Hkv * group;
  p.L = L;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  p.pages = pages;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.s_sb = strides[5];
  p.s_ss = strides[6];
  p.s_sh = strides[7];
  p.scale_log2 = scale * kLog2e;
  const bool paged = tables != nullptr;
  const Launch a{k,          v,          stage_k,    stage_v,    B,
                 Hkv,        cluster,    stage_len,  paged ? pages : B,
                 paged ? block_size : L, strides[2], strides[3], strides[4], strides[8],
                 strides[9], strides[10]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(head_dim, group, kv_int8, [&](auto d, auto g, auto i) {
    return launch<decltype(d)::value, decltype(g)::value, decltype(i)::value>(p, a, st);
  }));
}

}  // namespace

// strides: q_sb, q_sh, cache (k and v) sb/ss/sh, scales sb/ss/sh, staging
// (k and v) sb/ss/sh, in elements; the staging rows hold stage_len rows of
// which stage_rows are live. ``cluster``: the most blocks per (slot,
// kv head), 1..8; fewer where B x Hkv clusters of that size would not all
// be resident at once. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int kftpu_decode_attention(
    int head_dim, int group, int kv_int8, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lengths, const void* stage_k,
    const void* stage_v, int stage_rows, int stage_len, void* o, int B, int Hkv, int L,
    int cluster, const long long* strides, float scale, void* stream) {
  return decode_attention_impl(head_dim, group, kv_int8, q, k, v, k_scale, v_scale, lengths,
                               nullptr, 0, 0, 0, stage_k, stage_v, stage_rows, stage_len, o, B,
                               Hkv, L, cluster, strides, scale, stream);
}

// The same over a paged pool: k, v (and the scales) are [pages, block_size,
// Hkv, .] with the cache strides giving the page (sb), row (ss) and head
// (sh) steps; ``tables`` [B, max_blocks] int32 maps slot b's logical block
// j to its page; L = max_blocks x block_size. block_size must be a
// multiple of 16 (a chunk stays on one page).
extern "C" int kftpu_decode_attention_paged(
    int head_dim, int group, int kv_int8, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lengths, const void* tables,
    int max_blocks, int block_size, int pages, const void* stage_k, const void* stage_v,
    int stage_rows, int stage_len, void* o, int B, int Hkv, int cluster,
    const long long* strides, float scale, void* stream) {
  if (tables == nullptr || max_blocks <= 0 || block_size <= 0 || block_size % kRows != 0 ||
      pages <= 0) {
    return cudaErrorInvalidValue;
  }
  return decode_attention_impl(head_dim, group, kv_int8, q, k, v, k_scale, v_scale, lengths,
                               tables, max_blocks, block_size, pages, stage_k, stage_v,
                               stage_rows, stage_len, o, B, Hkv, max_blocks * block_size,
                               cluster, strides, scale, stream);
}

// The cluster size kftpu_decode_attention launches for these shapes
// (``cluster`` as there), or minus a CUDA error code.
extern "C" int kftpu_decode_attention_cluster(int head_dim, int group, int kv_int8, int B,
                                              int Hkv, int cluster) {
  if (B <= 0 || Hkv <= 0 || cluster < 1 || cluster > kMaxCluster) return -cudaErrorInvalidValue;
  int chosen = 1;
  const cudaError_t err = dispatch(head_dim, group, kv_int8, [&](auto d, auto g, auto i) {
    return plan<decltype(d)::value, decltype(g)::value, decltype(i)::value>(cluster, B * Hkv,
                                                                           &chosen);
  });
  return err == cudaSuccess ? chosen : -static_cast<int>(err);
}
