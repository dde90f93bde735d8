// adafactor's update of every parameter tensor, the global norm that
// clips it included, in seven launches, for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/ops/adafactor.py.
//
// Replaces the XLA fusion of the JAX trainer's adafactor chain,
// kubeflow_tpu/train/trainer.py::TrainConfig.make_optimizer (:146-152)
// under _f32_moments (:173), applied by optax.apply_updates (:487-490)
// inside the jitted step: clip_by_global_norm, then optax.adafactor's
// scale_by_factored_rms -> clip_by_block_rms(1) -> scale_by_learning_rate
// -> scale_by_param_block_rms(1e-3) -> add_decayed_weights(wd) ->
// scale(-1). There is no Pallas kernel behind it.
//
// Function, in f32 on f32 casts of the params and grads. A "block" is one
// JAX leaf: a projection stacked over every layer when the JAX tree is
// scanned, one layer's tensor when not. A factored tensor is one layer's
// slice of a leaf whose two largest axes d0 (largest) and d1 reach 128; it
// is seen as [b, i0, i1], b running over the other (batch) axes, with
// per-tensor strides into the port's [out, in] memory (the JAX axes land
// on a contiguous axis or on a stride of head_dim or embed there).
// g is the UNCLIPPED gradient: the global clip is one scalar s, since the
// clipped gradient s g gives mean(s^2 g^2 + eps) = s^2 mean(g^2) + eps
// and rms(s u) = s rms(u). So no element is divided.
//   norm = sqrt(sum of g^2)          (the sum rounded once to f32)
//   s = norm >= max_norm ? max_norm / norm : 1;   s2 = s * s
//   factored:   v_row[b,i1] = decay v_row + keep (s2 mean_i0(g g) + 1e-30)
//               v_col[b,i0] = decay v_col + keep (s2 mean_i1(g g) + 1e-30)
//               rcm[b] = mean_i1 v_row[b,i1]
//               u = (g * 1/sqrt(v_row / rcm)) * 1/sqrt(v_col)
//   unfactored: v = decay v + keep (s2 (g g) + 1e-30);  u = g * 1/sqrt(v)
//   per block:  scale = rms(p) <= 1e-3 ? 1e-3 : rms(p)
//               factor = ((s lr) scale) / max(1, s sqrt(sum(u^2) / n))
//   p = round_to_dtype(p - (u factor + wd p))       (+ wd p when wd != 0)
// Each step is one rounded f32 operation in the order written, which the
// plain version repeats (kubeflow_tpu_torch/ops/adafactor.py::
// update_reference), so given the same sums kernel and plain version agree
// bitwise; the sums (the norm, the means, rcm, the block sums) are taken in
// another order than PyTorch's. The reference's own order, (g / norm) *
// max_norm and u / max(1, rms(u)) an element, differs by f32 roundings.
//
// Bound on this card: bytes. The update must read g and p and write p once:
// 6 bytes a parameter with bf16 params and grads, 4.18 GB and 1.249 ms for
// the 697.4M-parameter model at 3.35 TB/s; the moments are under 1 MB.
// This design reads g three times and p twice (12 bytes a parameter, the
// norm included: no other pass reads the gradients for it).
//
// Design: seven launches (the three tile passes once for each (p, g) dtype
// pair present, so the f32 paths' registers do not lower the bf16 path's
// occupancy), no atomics, so two calls are bitwise equal.
// Every tensor is cut into tiles of 16384 elements: a factored tensor into
// tiles of one batch slice along the axis of d0 and d1 with the smaller
// stride ("fast", 8 elements a lane, 16-byte loads where that stride is 1)
// and the other ("slow", 8 rows a thread): 256 fast x 64 slow (a warp a
// row), or 128 x 128 where the fast extent is 128 (a half warp a row, so
// o_proj's head_dim rows leave no lane idle); an unfactored one into
// contiguous runs. A block a tile; a block finds its tensor by a binary
// search of the table's first tiles.
//   (a) tile_stats: the tile's partial sums of g^2 along the slow axis (one
//       per fast index) and along the fast axis (one per slow index), its
//       totals of g^2 and p^2.
//   (b) norm_reduce: one block sums the tiles' g^2 in tile order (in f64,
//       rounded once): norm, s and s2 on the device.
//   (c) moments: a thread per v_row and v_col entry sums its partials in
//       tile order (compensated, 32 loads in flight) and updates the
//       moment; a v_col entry also writes its column factor 1/sqrt(v_col).
//   (d) row_factors: a block per batch slice sums v_row into rcm and
//       writes the slice's row factors 1/sqrt(v_row / rcm).
//   (e) tile_u2: the tile's sum of u^2; an unfactored tile updates v.
//   (f) leaf_sums: a block per block of the chain (JAX leaf) sums its
//       tiles' u^2 and p^2 in tile order into its factor.
//   (g) apply: u again from the factors, then p: three products, one more
//       and a sum with the decay, a difference; no division.
// g is read three times and p twice; the factors and the sums are small.
// A thread issues its loads of several rows before it uses the first, and
// in the u passes the rows' factors after them, so they overlap: all
// eight rows of g and p (256 bytes, bf16) in tile_stats, of g (128 bytes)
// in tile_u2, four of g and p (128 bytes) in apply. A block's place in
// its tensor is 32-bit arithmetic: the chain before its first load is
// short.

#include <math.h>

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                        // slow rows a thread
constexpr int kTileF = 256;                     // wide tile: fast elements
constexpr int kTileS = kWarps * kRows;          //   and slow rows (64)
constexpr int kNarrowF = 128;                   // narrow tile (fast extent 128)
constexpr int kNarrowS = 2 * kWarps * kRows;    //   two rows a warp step (128)
// Bytes of the tile's rows a thread loads before it uses the first:
// tile_stats's registers hold eight rows of g and p, apply's four.
constexpr int kStatsAhead = 256, kAheadBytes = 128;
// Blocks a tile pass keeps on an SM: a register budget of 128 a thread.
constexpr int kTileBlocks = 2;
constexpr long long kTileElems = static_cast<long long>(kTileF) * kTileS;
static_assert(kTileElems == static_cast<long long>(kNarrowF) * kNarrowS, "tile sizes");
constexpr int kNormThreads = 1024;
constexpr int kEntries = kThreads;              // moment entries a block
constexpr int kSumAhead = 32;                   // partials a moments thread loads ahead
constexpr float kEps = 1e-30f;                  // adafactor's epsilon
constexpr float kMinScale = 1e-3f;              // scale_by_param_block_rms

// The table's int64 fields a tensor (the gradient's pointer is in grads[t]).
// kRF, kCF: where the tensor's row factors [B, n1] and column factors
// [B, n0] start in the scratch; kLeaf: its block of the chain.
enum Field {
  kP, kV, kVC, kNumel, kFirst, kFirstEntry, kFirstSlice, kFlags,
  kNF, kSF, kNS, kSS, kTilesF, kTilesS,
  kNA, kSA, kNB, kSB, kRA, kRB, kR1, kCA, kCB, kC0,
  kPF, kPS, kRF, kCF, kLeaf, kFields
};
// kFlags: p dtype | g dtype << 2 | factored << 4 | fast axis is d0 << 5 |
// 16-byte row loads << 6 | narrow tiles << 7.
constexpr long long kFactored = 1 << 4, kFastD0 = 1 << 5, kVec = 1 << 6, kNarrow = 1 << 7;
// The leaves' int64 fields: first tile, tiles, elements.
constexpr int kLeafFields = 3;
// The device scalars norm_reduce writes: norm, s, s2.
enum Scalar { kNorm, kS, kS2, kScalars };

struct Scalars {
  float max_norm, decay, keep, lr, wd;          // f32 casts of the host's values
};

// The tensor that owns block c by ``field`` (kFirst, kFirstEntry or
// kFirstSlice): the last t with table[t][field] <= c.
__device__ __forceinline__ int find_tensor(const long long* table, int T, long long c,
                                           int field) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kFields + field] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.f, __fsqrt_rn(x)); }

// The sum over the lanes of one row: all 32 of a wide tile's warp, or the
// 16 of a narrow tile's half warp (every lane takes part).
__device__ __forceinline__ float row_sum(float v, bool narrow) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    if (o < 16 || !narrow) v += other;
  }
  return v;
}

// Two sums over the block, in the fixed order of block_sum.
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = a;
    red[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  a = lane < kWarps ? red[0][lane] : 0.f;
  b = lane < kWarps ? red[1][lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Eight elements along the fast axis from ``off``, ``sF`` apart (``valid``
// of them; the rest read as 0).
template <typename T>
__device__ __forceinline__ void load_cols(const T* base, long long off, long long sF, int valid,
                                          float v[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < valid ? load1(base + off + j * sF) : 0.f;
}

// Their store: one 16-byte store when the row is contiguous and whole.
template <typename T>
__device__ __forceinline__ void store_cols(T* base, long long off, long long sF, int valid,
                                           bool vec, const float v[8]) {
  if (vec && valid == 8) {
    store8(base + off, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < valid) store1(base + off + j * sF, v[j]);
  }
}

// A factored tile's place: batch slice b (and its offset in the param),
// slow tile tS, fast tile tF.
struct Tile {
  long long b, tS, tF, off;
};

__device__ __forceinline__ Tile tile_of(const long long* d, long long tile) {
  // Tile counts are under 2^31 (the wrapper checks): 32-bit divisions.
  const unsigned lt = static_cast<unsigned>(tile - d[kFirst]);
  const unsigned tiles_f = static_cast<unsigned>(d[kTilesF]);
  const unsigned tiles_s = static_cast<unsigned>(d[kTilesS]);
  const unsigned nb = static_cast<unsigned>(d[kNB]);
  Tile t;
  t.tF = lt % tiles_f;
  const unsigned r = lt / tiles_f;
  t.tS = r % tiles_s;
  const unsigned b = r / tiles_s;
  t.b = b;
  t.off = (b / nb) * d[kSA] + (b % nb) * d[kSB];
  return t;
}

// Eight consecutive elements kept as loaded (16 or 32 bytes), so that a
// thread's rows can all be in flight before the first is used.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float v[8]) const {
    unpack2(w.x, v[0], v[1]);
    unpack2(w.y, v[2], v[3]);
    unpack2(w.z, v[4], v[5]);
    unpack2(w.w, v[6], v[7]);
  }
};
template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void unpack(float v[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// A thread's place in a factored tile: its first fast index (8 columns,
// ``valid`` of them in the tensor), its first slow row and the rows
// between its kRows rows (1 in a wide tile, 2 in a narrow one, whose half
// warps take alternate rows).
struct Lanes {
  long long iF0, iS0;
  int step, valid;
  bool narrow;
};

__device__ __forceinline__ Lanes lanes_of(const long long* d, const Tile& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Lanes l;
  l.narrow = d[kFlags] & kNarrow;
  l.step = l.narrow ? 2 : 1;
  const int per_row = l.narrow ? 16 : 32;
  l.iF0 = t.tF * (l.narrow ? kNarrowF : kTileF) + (lane % per_row) * 8;
  l.iS0 = t.tS * (l.narrow ? kNarrowS : kTileS) + warp * kRows * l.step + lane / per_row;
  l.valid = static_cast<int>(max(0LL, min(8LL, d[kNF] - l.iF0)));
  return l;
}

// Rows a thread loads before it uses the first: kBytes of them, a power
// of two up to kRows.
template <typename P, typename G, bool kNeedP, int kBytes>
__host__ __device__ constexpr int rows_ahead() {
  constexpr int per_row =
      8 * (static_cast<int>(sizeof(G)) + (kNeedP ? static_cast<int>(sizeof(P)) : 0));
  constexpr int n = kBytes / per_row;
  return n >= 8 ? 8 : (n >= 4 ? 4 : (n >= 2 ? 2 : 1));
}
static_assert(kRows == 8, "rows_ahead divides kRows");

// Calls fn(r, iS, off, valid, g[8], p[8]) for each row r of the thread's
// kRows rows of a factored tile that lies in the tensor (row iS at offset
// off, ``valid`` columns; p only when kNeedP), after ready(). Where the
// rows are contiguous and whole, the loads of kAhead rows are issued
// before ready() and before the first of them is used, so ready()'s loads
// overlap them and fn's stores do not wait on the next row's loads.
template <typename P, typename G, bool kNeedP, int kAhead, typename Ready, typename Fn>
__device__ __forceinline__ void for_rows(const long long* d, const G* g, const P* p, const Tile& t,
                                         const Lanes& l, Ready ready, Fn fn) {
  if (l.valid == 0) return;
  // The table's fields in registers: fn's stores could alias them.
  const long long nS = d[kNS], sS = d[kSS], sF = d[kSF];
  if ((d[kFlags] & kVec) && l.valid == 8) {
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += kAhead) {
      Raw<G> gr[kAhead];
      Raw<P> pr[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const long long iS = l.iS0 + (r0 + k) * l.step;
        if (iS < nS) {
          const long long off = t.off + iS * sS + l.iF0;
          gr[k].load(g + off);
          if (kNeedP) pr[k].load(p + off);
        }
      }
      if (r0 == 0) ready();
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const long long iS = l.iS0 + (r0 + k) * l.step;
        if (iS < nS) {
          float gv[8], pv[8] = {};
          gr[k].unpack(gv);
          if (kNeedP) pr[k].unpack(pv);
          fn(r0 + k, iS, t.off + iS * sS + l.iF0, 8, gv, pv);
        }
      }
    }
    return;
  }
  ready();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long iS = l.iS0 + r * l.step;
    if (iS >= nS) continue;
    const long long off = t.off + iS * sS + l.iF0 * sF;
    float gv[8], pv[8] = {};
    load_cols(g, off, sF, l.valid, gv);
    if (kNeedP) load_cols(p, off, sF, l.valid, pv);
    fn(r, iS, off, l.valid, gv, pv);
  }
}

// The factors of u = (g * row factor) * column factor for a thread's rows:
// its eight fast-index factors and its kRows slow-index ones, read from the
// scratch (row factors by i1, column factors by i0; the fast index is i0
// when fast is d0, else i1) after the rows' loads are issued.
struct Factors {
  bool fast_d0;
  float fast[8];          // by the thread's eight fast indices
  float slow[kRows];      // by its rows
};

__device__ __forceinline__ void factors_of(const long long* d, const float* scratch,
                                           const Tile& t, const Lanes& l, Factors& f) {
  f.fast_d0 = d[kFlags] & kFastD0;
  const float* fast = scratch + (f.fast_d0 ? d[kCF] : d[kRF]) + t.b * d[kNF];
  const float* slow = scratch + (f.fast_d0 ? d[kRF] : d[kCF]) + t.b * d[kNS];
  const long long nS = d[kNS];
#pragma unroll
  for (int j = 0; j < 8; ++j) f.fast[j] = j < l.valid ? fast[l.iF0 + j] : 1.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long iS = l.iS0 + r * l.step;
    f.slow[r] = iS < nS ? slow[iS] : 1.f;
  }
}

// u of a row's eight elements: (g * row factor) * column factor.
__device__ __forceinline__ void row_u(const Factors& f, int r, const float g[8], float u[8]) {
  const float slow = f.slow[r];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = f.fast_d0 ? __fmul_rn(__fmul_rn(g[j], slow), f.fast[j])
                     : __fmul_rn(__fmul_rn(g[j], f.fast[j]), slow);
  }
}

// (a) Partial sums of g^2 and the tile's totals of g^2 and p^2.
// ``red`` and ``cols`` are the kernel's shared memory.
template <typename P, typename G>
__device__ __forceinline__ void stats(const long long* d, const G* g, long long tile,
                                      float* scratch, float* tile_p2, float* tile_g2,
                                      float (*red)[kWarps], float (*cols)[kTileF]) {
  const P* p = reinterpret_cast<const P*>(d[kP]);
  float p2 = 0.f, g2 = 0.f;
  if (!(d[kFlags] & kFactored)) {
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    const long long full = (d[kFlags] & kVec) ? n / 8 * 8 : 0;
    for (long long i = threadIdx.x * 8LL; i < full; i += kThreads * 8LL) {
      float gv[8], pv[8];
      load8(g + start + i, gv);
      load8(p + start + i, pv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        g2 += gv[j] * gv[j];
        p2 += pv[j] * pv[j];
      }
    }
    for (long long i = full + threadIdx.x; i < n; i += kThreads) {
      const float gv = load1(g + start + i), pv = load1(p + start + i);
      g2 += gv * gv;
      p2 += pv * pv;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    float colacc[8] = {}, rowsum[kRows] = {};
    for_rows<P, G, true, rows_ahead<P, G, true, kStatsAhead>()>(
        d, g, p, t, l, [] {},
        [&](int r, long long, long long, int valid, const float* gv, const float* pv) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < valid) {
              const float sq = __fmul_rn(gv[j], gv[j]);
              colacc[j] += sq;
              rowsum[r] += sq;
              p2 += pv[j] * pv[j];
            }
          }
        });
    const long long nS = d[kNS];
    const int per_row = l.narrow ? 16 : 32;
    float* ps = scratch + d[kPS] + (t.b * d[kTilesF] + t.tF) * nS;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {   // a row's lanes take the same branch
      g2 += rowsum[r];
      const float sum = row_sum(rowsum[r], l.narrow);
      const long long iS = l.iS0 + r * l.step;
      if (iS < nS && lane % per_row == 0) ps[iS] = sum;
    }
    if (l.narrow) {                     // the two half warps' rows
#pragma unroll
      for (int j = 0; j < 8; ++j) colacc[j] += __shfl_xor_sync(0xffffffffu, colacc[j], 16);
    }
    if (lane < per_row) {
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[warp][lane * 8 + j] = colacc[j];
    }
    __syncthreads();
    const int width = l.narrow ? kNarrowF : kTileF;
    const long long iF = t.tF * width + threadIdx.x;
    if (threadIdx.x < width && iF < d[kNF]) {
      float c = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += cols[w][threadIdx.x];
      scratch[d[kPF] + (t.b * d[kTilesS] + t.tS) * d[kNF] + iF] = c;
    }
  }
  block_sum2(g2, p2, red);
  if (threadIdx.x == 0) {
    tile_g2[tile] = g2;
    tile_p2[tile] = p2;
  }
}

// The tensor of tile ``tile``, or null when its dtypes are not (P, G):
// each pass is one kernel per dtype pair, launched for the pairs present,
// so that the f32 paths' registers do not bound the bf16 one's occupancy.
template <typename P, typename G>
__device__ __forceinline__ const long long* tensor_of(const long long* table, int T,
                                                      long long tile, int& t) {
  t = find_tensor(table, T, tile, kFirst);
  const long long* e = table + t * kFields;
  const int want = (sizeof(P) == 2 ? kBF16 : kF32) | (sizeof(G) == 2 ? kBF16 : kF32) << 2;
  return (e[kFlags] & 15) == want ? e : nullptr;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
    tile_stats(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
               float* __restrict__ scratch, float* __restrict__ tile_p2,
               float* __restrict__ tile_g2) {
  __shared__ float red[2][kWarps];
  __shared__ float cols[kWarps][kTileF];
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  stats<P, G>(e, reinterpret_cast<const G*>(grads[t]), tile, scratch, tile_p2, tile_g2, red,
              cols);
}

// (b) One block: the tiles' g^2 in tile order, each thread's run in f64,
// then a fixed-order f64 sum, rounded once; then norm, s and s2.
__global__ void __launch_bounds__(kNormThreads)
    norm_reduce(const float* __restrict__ tile_g2, long long tiles, float max_norm,
                float* __restrict__ out) {
  __shared__ double red[kNormThreads / 32];
  double sum = 0.0;
  long long k = threadIdx.x;
  for (; k + 7 * kNormThreads < tiles; k += 8 * kNormThreads) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = tile_g2[k + j * kNormThreads];
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += x[j];
  }
  for (; k < tiles; k += kNormThreads) sum += tile_g2[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  double total = red[threadIdx.x];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(__double2float_rn(total));
    const float s = norm >= max_norm ? __fdiv_rn(max_norm, norm) : 1.f;
    out[kNorm] = norm;
    out[kS] = s;
    out[kS2] = __fmul_rn(s, s);
  }
}

// (c) v_row and v_col from the tiles' partials, a thread an entry: the
// fast entries [b, iF] first, then the slow ones [b, iS]; a v_col entry
// also writes its column factor.
__global__ void __launch_bounds__(kThreads)
    moments(const long long* __restrict__ table, int T, float* __restrict__ scratch,
            const float* __restrict__ scalars, Scalars s) {
  const long long c = blockIdx.x;
  const int t = find_tensor(table, T, c, kFirstEntry);
  const long long* d = table + t * kFields;
  const long long nF = d[kNF], nS = d[kNS], B = d[kNA] * d[kNB];
  // Entry counts are under 2^31 (the wrapper checks): 32-bit divisions.
  unsigned e = static_cast<unsigned>((c - d[kFirstEntry]) * kEntries + threadIdx.x);
  if (e >= B * (nF + nS)) return;
  const bool fast_d0 = d[kFlags] & kFastD0;
  long long b, i, n, base, tiles, stride;
  bool to_col;
  if (e < B * nF) {
    b = e / static_cast<unsigned>(nF);
    i = e % static_cast<unsigned>(nF);
    base = d[kPF] + b * d[kTilesS] * nF + i;
    tiles = d[kTilesS];
    stride = nF;
    n = nS;
    to_col = fast_d0;
  } else {
    e -= static_cast<unsigned>(B * nF);
    b = e / static_cast<unsigned>(nS);
    i = e % static_cast<unsigned>(nS);
    base = d[kPS] + b * d[kTilesF] * nS + i;
    tiles = d[kTilesF];
    stride = nS;
    n = nF;
    to_col = !fast_d0;
  }
  // The tiles' partials in tile order, compensated (Kahan): the
  // embedding's sums over its 32000 rows span 500 tiles. kSumAhead loads
  // are issued before their sums, so a long sum is a short chain of
  // latencies.
  float sum = 0.f, comp = 0.f;
  const auto add = [&](float x) {
    const float y = __fsub_rn(x, comp);
    const float next = __fadd_rn(sum, y);
    comp = __fsub_rn(__fsub_rn(next, sum), y);
    sum = next;
  };
  long long k = 0;
  for (; k + kSumAhead <= tiles; k += kSumAhead) {
    float x[kSumAhead];
#pragma unroll
    for (int j = 0; j < kSumAhead; ++j) x[j] = scratch[base + (k + j) * stride];
#pragma unroll
    for (int j = 0; j < kSumAhead; ++j) add(x[j]);
  }
  for (; k < tiles; ++k) add(scratch[base + k * stride]);
  const float mean = __fdiv_rn(sum, static_cast<float>(n));
  const float sq = __fadd_rn(__fmul_rn(scalars[kS2], mean), kEps);
  const long long bA = b / d[kNB], bB = b % d[kNB];
  float* v = to_col ? reinterpret_cast<float*>(d[kVC]) + bA * d[kCA] + bB * d[kCB] + i * d[kC0]
                    : reinterpret_cast<float*>(d[kV]) + bA * d[kRA] + bB * d[kRB] + i * d[kR1];
  const float nv = __fadd_rn(__fmul_rn(s.decay, *v), __fmul_rn(s.keep, sq));
  *v = nv;
  if (to_col) scratch[d[kCF] + b * (fast_d0 ? nF : nS) + i] = rsqrt_rn(nv);
}

// (d) A block per batch slice b of a factored tensor: rcm = mean over i1
// of v_row[b, i1], summed in a fixed order, then the row factors.
__global__ void __launch_bounds__(kThreads)
    row_factors(const long long* __restrict__ table, int T, float* __restrict__ scratch) {
  __shared__ float red[kWarps];
  const long long c = blockIdx.x;
  const int t = find_tensor(table, T, c, kFirstSlice);
  const long long* d = table + t * kFields;
  const long long b = c - d[kFirstSlice];
  const float* vr =
      reinterpret_cast<const float*>(d[kV]) + b / d[kNB] * d[kRA] + b % d[kNB] * d[kRB];
  const long long n1 = (d[kFlags] & kFastD0) ? d[kNS] : d[kNF], r1 = d[kR1];
  float sum = 0.f;
  for (long long i = threadIdx.x; i < n1; i += kThreads) sum += vr[i * r1];
  const float rcm = __fdiv_rn(block_sum<kThreads>(sum, red), static_cast<float>(n1));
  float* rf = scratch + d[kRF] + b * n1;
  for (long long i = threadIdx.x; i < n1; i += kThreads) {
    rf[i] = rsqrt_rn(__fdiv_rn(vr[i * r1], rcm));
  }
}

// An unfactored element's new v: decay v + keep (s2 (g g) + eps).
__device__ __forceinline__ float new_v(float v, float g, float s2, const Scalars& s) {
  return __fadd_rn(__fmul_rn(s.decay, v),
                   __fmul_rn(s.keep, __fadd_rn(__fmul_rn(s2, __fmul_rn(g, g)), kEps)));
}

// (e) The tile's sum of u^2; an unfactored tile's v update.
template <typename G>
__device__ __forceinline__ void u2_sum(const long long* d, const G* g, long long tile,
                                       float s2, const Scalars& s, const float* scratch,
                                       float* tile_u2s) {
  __shared__ float red[kWarps];
  float u2 = 0.f;
  if (!(d[kFlags] & kFactored)) {
    float* v = reinterpret_cast<float*>(d[kV]);
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    const long long full = (d[kFlags] & kVec) ? n / 8 * 8 : 0;
    for (long long i = threadIdx.x * 8LL; i < full; i += kThreads * 8LL) {
      float gv[8], vv[8];
      load8(g + start + i, gv);
      load8(v + start + i, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vv[j] = new_v(vv[j], gv[j], s2, s);
        const float u = __fmul_rn(gv[j], rsqrt_rn(vv[j]));
        u2 += u * u;
      }
      store8(v + start + i, vv);
    }
    for (long long i = full + threadIdx.x; i < n; i += kThreads) {
      const float gv = load1(g + start + i);
      const float nv = new_v(v[start + i], gv, s2, s);
      v[start + i] = nv;
      const float u = __fmul_rn(gv, rsqrt_rn(nv));
      u2 += u * u;
    }
  } else {
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    Factors f;
    for_rows<G, G, false, rows_ahead<G, G, false, kAheadBytes>()>(
        d, g, g, t, l, [&] { factors_of(d, scratch, t, l, f); },
        [&](int r, long long, long long, int valid, const float* gv, const float*) {
          float u[8];
          row_u(f, r, gv, u);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < valid) u2 += u[j] * u[j];
          }
        });
  }
  const float total = block_sum<kThreads>(u2, red);
  if (threadIdx.x == 0) tile_u2s[tile] = total;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
    tile_u2(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
            const float* __restrict__ scalars, Scalars s, const float* __restrict__ scratch,
            float* __restrict__ tile_u2s) {
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  u2_sum(e, reinterpret_cast<const G*>(grads[t]), tile, scalars[kS2], s, scratch, tile_u2s);
}

// (f) A block per leaf: its tiles' sums of u^2 and p^2 in tile order, then
// its factor ((s lr) scale) / max(1, s rms(u)).
__global__ void __launch_bounds__(kThreads)
    leaf_sums(const long long* __restrict__ leaves, const float* __restrict__ tile_p2,
              const float* __restrict__ tile_u2s, const float* __restrict__ scalars, Scalars s,
              float* __restrict__ out) {
  __shared__ float red[2][kWarps];
  const long long* l = leaves + blockIdx.x * kLeafFields;
  float su = 0.f, sp = 0.f;
  for (long long k = threadIdx.x; k < l[1]; k += kThreads) {
    su += tile_u2s[l[0] + k];
    sp += tile_p2[l[0] + k];
  }
  block_sum2(su, sp, red);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(l[2]), sc = scalars[kS];
    const float denom = fmaxf(1.f, __fmul_rn(sc, __fsqrt_rn(__fdiv_rn(su, n))));
    const float rms_p = __fsqrt_rn(__fdiv_rn(sp, n));
    const float scale = rms_p <= kMinScale ? kMinScale : rms_p;
    out[blockIdx.x] = __fdiv_rn(__fmul_rn(__fmul_rn(sc, s.lr), scale), denom);
  }
}

// One element's update from u: p - (u factor + wd p).
__device__ __forceinline__ float apply1(float p, float u, float factor, const Scalars& s) {
  u = __fmul_rn(u, factor);
  if (s.wd != 0.f) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  return __fsub_rn(p, u);
}

// (g) The apply.
template <typename P, typename G>
__device__ __forceinline__ void apply(const long long* d, const G* g, long long tile,
                                      const Scalars& s, const float* scratch,
                                      const float* leaf_out) {
  const float factor = leaf_out[d[kLeaf]];
  P* p = reinterpret_cast<P*>(d[kP]);
  if (!(d[kFlags] & kFactored)) {
    const float* v = reinterpret_cast<const float*>(d[kV]);
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const float u = __fmul_rn(load1(g + start + i), rsqrt_rn(v[start + i]));
      store1(p + start + i, apply1(load1(p + start + i), u, factor, s));
    }
  } else {
    const long long sF = d[kSF];
    const bool vec = d[kFlags] & kVec;
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    Factors f;
    for_rows<P, G, true, rows_ahead<P, G, true, kAheadBytes>()>(
        d, g, p, t, l, [&] { factors_of(d, scratch, t, l, f); },
        [&](int r, long long, long long off, int valid, const float* gv, const float* pv) {
          float u[8], out[8];
          row_u(f, r, gv, u);
#pragma unroll
          for (int j = 0; j < 8; ++j) out[j] = apply1(pv[j], u[j], factor, s);
          store_cols(p, off, sF, valid, vec, out);
        });
  }
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
    apply_update(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
                 Scalars s, const float* __restrict__ scratch,
                 const float* __restrict__ leaf_out) {
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  apply<P, G>(e, reinterpret_cast<const G*>(grads[t]), tile, s, scratch, leaf_out);
}

bool launched(cudaError_t& err) { return (err = cudaGetLastError()) == cudaSuccess; }

}  // namespace

// The tile's elements, the wide and narrow tiles' fast and slow extents,
// the table's fields a tensor and a leaf, the device scalars and the
// moment entries a block (the wrapper checks its constants against them).
extern "C" long long kftpu_adafactor_layout(int which) {
  const long long v[] = {kTileElems, kTileF,      kTileS,   kNarrowF, kNarrowS,
                         kFields,    kLeafFields, kScalars, kEntries};
  return which >= 0 && which < 9 ? v[which] : -1;
}

// Bytes of gradient rows in flight on an SM in the bf16 tile_u2 pass (the
// pass that reads g alone): its resident blocks (the occupancy API) x
// threads x the rows a thread loads ahead x 16 bytes; -1 on error.
extern "C" long long kftpu_adafactor_inflight() {
  int blocks = 0;
  using B = __nv_bfloat16;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tile_u2<B, B>, kThreads, 0) !=
      cudaSuccess) {
    return -1;
  }
  return static_cast<long long>(blocks) * kThreads * rows_ahead<B, B, false, kAheadBytes>() * 16;
}

// One adafactor step in place over the table's T tensors in L leaves
// (``tiles`` tiles, ``entry_blocks`` blocks of moment entries and
// ``slices`` batch slices of factored tensors in all), clipped by the
// gradients' global norm, which it computes into ``scalars`` (device f32
// [3]: norm, s, s2); ``pairs``: the (p, g) dtype pairs present, bit
// (p | g << 2) for each (0 = f32, 1 = bf16), one launch of each tile pass
// per pair. ``table``: device int64 [T, kFields] (see Field);
// ``leaves``: device int64 [L, 3] (first tile, tiles, elements);
// ``grads``: device int64 [T], the gradients' pointers; ``scratch``: f32,
// the partial sums of g^2 and the factors (at each tensor's kPF, kPS, kRF,
// kCF), then the tiles' sums of p^2 (at ``p2_at``), of u^2 (at ``u2_at``)
// and of g^2 (at ``g2_at``) and the leaves' factors (at ``leaf_at``). The
// scalars are the plain version's f32 casts. Returns the CUDA error code
// of the launches (0 = launched).
extern "C" int kftpu_adafactor_update(const void* table, const void* leaves, const void* grads,
                                      int T, int L, int pairs, long long tiles,
                                      long long entry_blocks, long long slices, void* scratch,
                                      long long p2_at, long long u2_at, long long g2_at,
                                      long long leaf_at, void* scalars, float max_norm,
                                      float decay, float keep, float lr, float wd,
                                      void* stream) {
  constexpr long long kMax = 1LL << 31;
  if (T <= 0 || L <= 0 || (pairs & ~51) || !pairs || tiles <= 0 || tiles >= kMax ||
      entry_blocks < 0 || entry_blocks * kEntries >= kMax || slices < 0 || slices >= kMax) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars s{max_norm, decay, keep, lr, wd};
  const long long* tab = static_cast<const long long*>(table);
  const long long* gp = static_cast<const long long*>(grads);
  float* scr = static_cast<float*>(scratch);
  float* sc = static_cast<float*>(scalars);
  float *p2 = scr + p2_at, *u2 = scr + u2_at, *g2 = scr + g2_at;
  const unsigned grid = static_cast<unsigned>(tiles);
  using B = __nv_bfloat16;
  // The dtype pairs present: bit (p | g << 2) of ``pairs``.
  const bool ff = pairs & 1, bf = pairs & 2, fb = pairs & 16, bb = pairs & 32;
  cudaError_t err;
  if (ff) tile_stats<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, scr, p2, g2);
  if (bf) tile_stats<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, scr, p2, g2);
  if (fb) tile_stats<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, scr, p2, g2);
  if (bb) tile_stats<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, scr, p2, g2);
  if (!launched(err)) return err;
  norm_reduce<<<1, kNormThreads, 0, st>>>(g2, tiles, max_norm, sc);
  if (!launched(err)) return err;
  if (entry_blocks > 0) {
    moments<<<static_cast<unsigned>(entry_blocks), kThreads, 0, st>>>(tab, T, scr, sc, s);
    if (!launched(err)) return err;
    row_factors<<<static_cast<unsigned>(slices), kThreads, 0, st>>>(tab, T, scr);
    if (!launched(err)) return err;
  }
  if (ff) tile_u2<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, sc, s, scr, u2);
  if (bf) tile_u2<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, sc, s, scr, u2);
  if (fb) tile_u2<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, sc, s, scr, u2);
  if (bb) tile_u2<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, sc, s, scr, u2);
  if (!launched(err)) return err;
  leaf_sums<<<static_cast<unsigned>(L), kThreads, 0, st>>>(static_cast<const long long*>(leaves),
                                                            p2, u2, sc, s, scr + leaf_at);
  if (!launched(err)) return err;
  const float* lo = scr + leaf_at;
  if (ff) apply_update<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, s, scr, lo);
  if (bf) apply_update<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, s, scr, lo);
  if (fb) apply_update<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, s, scr, lo);
  if (bb) apply_update<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, s, scr, lo);
  launched(err);
  return err;
}
