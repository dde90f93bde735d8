// adafactor's update of every parameter tensor in six launches, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes); see
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
//   g  = clip ? (g / norm) * max_norm : g        (norm: K5's, on the device)
//   factored:   v_row[b,i1] = decay v_row + keep mean_i0(g^2 + 1e-30)
//               v_col[b,i0] = decay v_col + keep mean_i1(g^2 + 1e-30)
//               rcm[b] = mean_i1 v_row[b,i1]
//               u = (g * 1/sqrt(v_row / rcm)) * 1/sqrt(v_col)
//   unfactored: v = decay v + keep (g^2 + 1e-30);  u = g * 1/sqrt(v)
//   per block:  u = u / max(1, rms(u));  u = lr u;
//               u = u * (rms(p) <= 1e-3 ? 1e-3 : rms(p));  u = u + wd p
//   p = round_to_dtype(p - u)
// Each element-wise step is one rounded f32 operation in the plain
// version's order (kubeflow_tpu_torch/ops/adafactor.py::update_reference),
// so given the same sums kernel and plain version agree bitwise; the sums
// (means, rcm, block RMS) are taken in another order than PyTorch's.
//
// Bound on this card: bytes. The update must read g and p and write p once:
// 6 bytes a parameter with bf16 params and grads, 4.18 GB and 1.249 ms for
// the 697.4M-parameter model at 3.35 TB/s; the moments are under 1 MB.
// This design reads g three times and p twice (12 bytes a parameter).
//
// Design: six launches (the three tile passes once for each (p, g) dtype
// pair present, so the f32 paths' registers do not lower the bf16 path's
// occupancy), no atomics, so two calls are bitwise equal.
// Every tensor is cut into tiles of 16384 elements: a factored tensor into
// 64 x 256 tiles of one batch slice, the 256 along the axis of d0 and d1
// with the smaller stride ("fast": 32 lanes x 8 elements, 16-byte loads
// where that stride is 1), the 64 along the other ("slow": 8 warps x 8
// rows); an unfactored one into contiguous runs. A block a tile; a block
// finds its tensor by a binary search of the table's first tiles.
//   (a) tile_stats: the tile's partial sums of g^2 + eps along the slow
//       axis (one per fast index) and along the fast axis (one per slow
//       index), its sum of p^2; an unfactored tile updates v in place.
//   (b) moments: a thread per v_row and v_col entry sums its partials in
//       tile order (compensated) and updates the moment; a v_col entry
//       also writes its column factor 1/sqrt(v_col).
//   (c) row_factors: a block per batch slice sums v_row into rcm and
//       writes the slice's row factors 1/sqrt(v_row / rcm).
//   (d) tile_u2: the tile's sum of u^2.
//   (e) leaf_sums: a block per block of the chain (JAX leaf) sums its
//       tiles' u^2 and p^2 in tile order: the clip denominator and the
//       parameter scale.
//   (f) apply: u again from the factors, then p.
// g is read three times and p twice; the factors and the sums are small.
// A thread loads four rows (16 bytes each of g and p) before it uses the
// first, so its loads overlap.

#include <math.h>

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileF = 256;                     // fast-axis elements a tile
constexpr int kTileS = 64;                      // slow-axis rows a tile
constexpr int kRows = kTileS / kWarps;          // rows a warp
constexpr int kAhead = 4;                       // rows a thread loads ahead
// Blocks a tile pass keeps on an SM: a register budget of 128 a thread.
constexpr int kTileBlocks = 2;
constexpr long long kTileElems = static_cast<long long>(kTileF) * kTileS;
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
// 16-byte row loads << 6.
constexpr long long kFactored = 1 << 4, kFastD0 = 1 << 5, kVec = 1 << 6;
// The leaves' int64 fields: first tile, tiles, elements.
constexpr int kLeafFields = 3;

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

__device__ __forceinline__ float clip_g(float g, bool clip, float norm, float max_norm) {
  return clip ? __fmul_rn(__fdiv_rn(g, norm), max_norm) : g;
}

__device__ __forceinline__ float sq_eps(float g) { return __fadd_rn(__fmul_rn(g, g), kEps); }

__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.f, __fsqrt_rn(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  const long long lt = tile - d[kFirst];
  Tile t;
  t.tF = lt % d[kTilesF];
  const long long r = lt / d[kTilesF];
  t.tS = r % d[kTilesS];
  t.b = r / d[kTilesS];
  t.off = t.b / d[kNB] * d[kSA] + t.b % d[kNB] * d[kSB];
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
// ``valid`` of them in the tensor) and its first slow row (kRows rows).
struct Lanes {
  long long iF0, iS0;
  int valid;
};

__device__ __forceinline__ Lanes lanes_of(const long long* d, const Tile& t) {
  Lanes l;
  l.iF0 = t.tF * kTileF + (threadIdx.x & 31) * 8;
  l.iS0 = t.tS * kTileS + (threadIdx.x >> 5) * kRows;
  l.valid = static_cast<int>(max(0LL, min(8LL, d[kNF] - l.iF0)));
  return l;
}

// Calls fn(r, iS, off, valid, g[8], p[8]) for each row r of the thread's
// kRows rows of a factored tile that lies in the tensor (row iS at offset
// off, ``valid`` columns; p only when kNeedP). Where the rows are
// contiguous and whole, the loads of kAhead rows are issued before the
// first of them is used, so fn's stores do not wait on the next row's
// loads.
template <typename P, typename G, bool kNeedP, typename Fn>
__device__ __forceinline__ void for_rows(const long long* d, const G* g, const P* p, const Tile& t,
                                         const Lanes& l, Fn fn) {
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
        if (l.iS0 + r0 + k < nS) {
          const long long off = t.off + (l.iS0 + r0 + k) * sS + l.iF0;
          gr[k].load(g + off);
          if (kNeedP) pr[k].load(p + off);
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const long long iS = l.iS0 + r0 + k;
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
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (l.iS0 + r >= nS) continue;
    const long long off = t.off + (l.iS0 + r) * sS + l.iF0 * sF;
    float gv[8], pv[8] = {};
    load_cols(g, off, sF, l.valid, gv);
    if (kNeedP) load_cols(p, off, sF, l.valid, pv);
    fn(r, l.iS0 + r, off, l.valid, gv, pv);
  }
}

// u = (g * row factor) * column factor for a row's eight elements, the
// factors read from the scratch (row factors by i1, column factors by i0;
// the fast index is i0 when fast is d0, else i1).
struct Factors {
  const float* fast;      // by the fast index
  const float* slow;      // by the slow index
  bool fast_d0;
  float col[8];           // the thread's eight fast-index factors
};

__device__ __forceinline__ Factors factors_of(const long long* d, const float* scratch,
                                              const Tile& t, const Lanes& l) {
  Factors f;
  f.fast_d0 = d[kFlags] & kFastD0;
  f.fast = scratch + (f.fast_d0 ? d[kCF] : d[kRF]) + t.b * d[kNF];
  f.slow = scratch + (f.fast_d0 ? d[kRF] : d[kCF]) + t.b * d[kNS];
#pragma unroll
  for (int j = 0; j < 8; ++j) f.col[j] = j < l.valid ? f.fast[l.iF0 + j] : 1.f;
  return f;
}

__device__ __forceinline__ void row_u(const Factors& f, long long iS, bool clip, float norm,
                                      const Scalars& s, const float g[8], float u[8]) {
  const float rowf = f.slow[iS];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float gg = clip_g(g[j], clip, norm, s.max_norm);
    u[j] = f.fast_d0 ? __fmul_rn(__fmul_rn(gg, rowf), f.col[j])
                     : __fmul_rn(__fmul_rn(gg, f.col[j]), rowf);
  }
}

// (a) Partial sums of g^2 + eps and of p^2; the unfactored v update.
// ``red`` and ``cols`` are the kernel's shared memory.
template <typename P, typename G>
__device__ __forceinline__ void stats(const long long* d, const G* g, long long tile, bool clip,
                                      float norm, const Scalars& s, float* scratch,
                                      float* tile_p2, float* red, float (*cols)[kTileF]) {
  const P* p = reinterpret_cast<const P*>(d[kP]);
  float p2 = 0.f;
  if (!(d[kFlags] & kFactored)) {
    float* v = reinterpret_cast<float*>(d[kV]);
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    const long long full = (d[kFlags] & kVec) ? n / 8 * 8 : 0;
    for (long long i = threadIdx.x * 8LL; i < full; i += kThreads * 8LL) {
      float gv[8], pv[8], vv[8];
      load8(g + start + i, gv);
      load8(p + start + i, pv);
      load8(v + start + i, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sq = sq_eps(clip_g(gv[j], clip, norm, s.max_norm));
        vv[j] = __fadd_rn(__fmul_rn(s.decay, vv[j]), __fmul_rn(s.keep, sq));
        p2 += pv[j] * pv[j];
      }
      store8(v + start + i, vv);
    }
    for (long long i = full + threadIdx.x; i < n; i += kThreads) {
      const float sq = sq_eps(clip_g(load1(g + start + i), clip, norm, s.max_norm));
      v[start + i] = __fadd_rn(__fmul_rn(s.decay, v[start + i]), __fmul_rn(s.keep, sq));
      const float pv = load1(p + start + i);
      p2 += pv * pv;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    float colacc[8] = {}, rowsum[kRows] = {};
    for_rows<P, G, true>(d, g, p, t, l,
                         [&](int r, long long, long long, int valid, const float* gv,
                             const float* pv) {
#pragma unroll
                           for (int j = 0; j < 8; ++j) {
                             if (j < valid) {
                               const float sq = sq_eps(clip_g(gv[j], clip, norm, s.max_norm));
                               colacc[j] += sq;
                               rowsum[r] += sq;
                               p2 += pv[j] * pv[j];
                             }
                           }
                         });
    const long long nS = d[kNS];
    float* ps = scratch + d[kPS] + (t.b * d[kTilesF] + t.tF) * nS;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {         // rows are uniform across a warp
      const float sum = warp_sum(rowsum[r]);
      if (l.iS0 + r < nS && lane == 0) ps[l.iS0 + r] = sum;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cols[warp][lane * 8 + j] = colacc[j];
    __syncthreads();
    const long long iF = t.tF * kTileF + threadIdx.x;
    if (iF < d[kNF]) {
      float c = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += cols[w][threadIdx.x];
      scratch[d[kPF] + (t.b * d[kTilesS] + t.tS) * d[kNF] + iF] = c;
    }
  }
  const float total = block_sum<kThreads>(p2, red);
  if (threadIdx.x == 0) tile_p2[tile] = total;
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
               const float* __restrict__ norm_ptr, Scalars s, float* __restrict__ scratch,
               float* __restrict__ tile_p2) {
  __shared__ float red[kWarps];
  __shared__ float cols[kWarps][kTileF];
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  const float norm = norm_ptr[0];
  stats<P, G>(e, reinterpret_cast<const G*>(grads[t]), tile, norm >= s.max_norm, norm, s,
              scratch, tile_p2, red, cols);
}

// (b) v_row and v_col from the tiles' partials, a thread an entry: the
// fast entries [b, iF] first, then the slow ones [b, iS]; a v_col entry
// also writes its column factor.
__global__ void __launch_bounds__(kThreads)
    moments(const long long* __restrict__ table, int T, float* __restrict__ scratch,
            Scalars s) {
  const long long c = blockIdx.x;
  const int t = find_tensor(table, T, c, kFirstEntry);
  const long long* d = table + t * kFields;
  const long long nF = d[kNF], nS = d[kNS], B = d[kNA] * d[kNB];
  long long e = (c - d[kFirstEntry]) * kThreads + threadIdx.x;
  if (e >= B * (nF + nS)) return;
  const bool fast_d0 = d[kFlags] & kFastD0;
  long long b, i, n, base, tiles, stride;
  bool to_col;
  if (e < B * nF) {
    b = e / nF;
    i = e % nF;
    base = d[kPF] + b * d[kTilesS] * nF + i;
    tiles = d[kTilesS];
    stride = nF;
    n = nS;
    to_col = fast_d0;
  } else {
    e -= B * nF;
    b = e / nS;
    i = e % nS;
    base = d[kPS] + b * d[kTilesF] * nS + i;
    tiles = d[kTilesF];
    stride = nS;
    n = nF;
    to_col = !fast_d0;
  }
  // The tiles' partials in tile order, compensated (Kahan): the
  // embedding's sums over its 32000 rows span 500 tiles. Eight loads are
  // issued before their sums, so a long sum is not a chain of latencies.
  float sum = 0.f, comp = 0.f;
  const auto add = [&](float x) {
    const float y = __fsub_rn(x, comp);
    const float next = __fadd_rn(sum, y);
    comp = __fsub_rn(__fsub_rn(next, sum), y);
    sum = next;
  };
  long long k = 0;
  for (; k + 8 <= tiles; k += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = scratch[base + (k + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) add(x[j]);
  }
  for (; k < tiles; ++k) add(scratch[base + k * stride]);
  const float mean = __fdiv_rn(sum, static_cast<float>(n));
  const long long bA = b / d[kNB], bB = b % d[kNB];
  float* v = to_col ? reinterpret_cast<float*>(d[kVC]) + bA * d[kCA] + bB * d[kCB] + i * d[kC0]
                    : reinterpret_cast<float*>(d[kV]) + bA * d[kRA] + bB * d[kRB] + i * d[kR1];
  const float nv = __fadd_rn(__fmul_rn(s.decay, *v), __fmul_rn(s.keep, mean));
  *v = nv;
  if (to_col) scratch[d[kCF] + b * (fast_d0 ? nF : nS) + i] = rsqrt_rn(nv);
}

// (c) A block per batch slice b of a factored tensor: rcm = mean over i1
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

// (d) The tile's sum of u^2.
template <typename G>
__device__ __forceinline__ void u2_sum(const long long* d, const G* g, long long tile, bool clip,
                                       float norm, const Scalars& s, const float* scratch,
                                       float* tile_u2s) {
  __shared__ float red[kWarps];
  float u2 = 0.f;
  if (!(d[kFlags] & kFactored)) {
    const float* v = reinterpret_cast<const float*>(d[kV]);
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const float u = __fmul_rn(clip_g(load1(g + start + i), clip, norm, s.max_norm),
                                rsqrt_rn(v[start + i]));
      u2 += u * u;
    }
  } else {
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    const Factors f = factors_of(d, scratch, t, l);
    for_rows<G, G, false>(d, g, g, t, l,
                          [&](int, long long iS, long long, int valid, const float* gv,
                              const float*) {
                            float u[8];
                            row_u(f, iS, clip, norm, s, gv, u);
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
            const float* __restrict__ norm_ptr, Scalars s, const float* __restrict__ scratch,
            float* __restrict__ tile_u2s) {
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  const float norm = norm_ptr[0];
  u2_sum(e, reinterpret_cast<const G*>(grads[t]), tile, norm >= s.max_norm, norm, s,
         scratch, tile_u2s);
}

// (e) A block per leaf: its tiles' sums of u^2 and p^2 in tile order, then
// [denominator, scale]: max(1, rms(u)) and max-or-min(rms(p), 1e-3).
__global__ void __launch_bounds__(kThreads)
    leaf_sums(const long long* __restrict__ leaves, const float* __restrict__ tile_p2,
              const float* __restrict__ tile_u2s, float* __restrict__ out) {
  __shared__ float red[kWarps];
  const long long* l = leaves + blockIdx.x * kLeafFields;
  float su = 0.f, sp = 0.f;
  for (long long k = threadIdx.x; k < l[1]; k += kThreads) {
    su += tile_u2s[l[0] + k];
    sp += tile_p2[l[0] + k];
  }
  su = block_sum<kThreads>(su, red);
  sp = block_sum<kThreads>(sp, red);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(l[2]);
    const float rms_p = __fsqrt_rn(__fdiv_rn(sp, n));
    out[2 * blockIdx.x] = fmaxf(1.f, __fsqrt_rn(__fdiv_rn(su, n)));
    out[2 * blockIdx.x + 1] = rms_p <= kMinScale ? kMinScale : rms_p;
  }
}

// One element's update from u, in the chain's order.
__device__ __forceinline__ float apply1(float p, float u, float denom, float scale,
                                       const Scalars& s) {
  u = __fmul_rn(s.lr, __fdiv_rn(u, denom));
  u = __fmul_rn(u, scale);
  if (s.wd != 0.f) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  return __fsub_rn(p, u);
}

// (f) The apply.
template <typename P, typename G>
__device__ __forceinline__ void apply(const long long* d, const G* g, long long tile, bool clip,
                                      float norm, const Scalars& s, const float* scratch,
                                      const float* leaf_out) {
  const float denom = leaf_out[2 * d[kLeaf]], scale = leaf_out[2 * d[kLeaf] + 1];
  P* p = reinterpret_cast<P*>(d[kP]);
  if (!(d[kFlags] & kFactored)) {
    const float* v = reinterpret_cast<const float*>(d[kV]);
    const long long start = (tile - d[kFirst]) * kTileElems;
    const long long n = min(kTileElems, d[kNumel] - start);
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const float u = __fmul_rn(clip_g(load1(g + start + i), clip, norm, s.max_norm),
                                rsqrt_rn(v[start + i]));
      store1(p + start + i, apply1(load1(p + start + i), u, denom, scale, s));
    }
  } else {
    const long long sF = d[kSF];
    const bool vec = d[kFlags] & kVec;
    const Tile t = tile_of(d, tile);
    const Lanes l = lanes_of(d, t);
    const Factors f = factors_of(d, scratch, t, l);
    for_rows<P, G, true>(d, g, p, t, l,
                         [&](int, long long iS, long long off, int valid, const float* gv,
                             const float* pv) {
                           float u[8], out[8];
                           row_u(f, iS, clip, norm, s, gv, u);
#pragma unroll
                           for (int j = 0; j < 8; ++j) {
                             out[j] = apply1(pv[j], u[j], denom, scale, s);
                           }
                           store_cols(p, off, sF, valid, vec, out);
                         });
  }
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
    apply_update(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
                 const float* __restrict__ norm_ptr, Scalars s,
                 const float* __restrict__ scratch, const float* __restrict__ leaf_out) {
  const long long tile = blockIdx.x;
  int t;
  const long long* e = tensor_of<P, G>(table, T, tile, t);
  if (e == nullptr) return;
  const float norm = norm_ptr[0];
  apply<P, G>(e, reinterpret_cast<const G*>(grads[t]), tile, norm >= s.max_norm, norm, s,
              scratch, leaf_out);
}

bool launched(cudaError_t& err) { return (err = cudaGetLastError()) == cudaSuccess; }

}  // namespace

// The tile's elements, fast and slow extents, and the table's fields a
// tensor and a leaf (the wrapper checks its constants against them).
extern "C" long long kftpu_adafactor_layout(int which) {
  const long long v[] = {kTileElems, kTileF, kTileS, kFields, kLeafFields};
  return which >= 0 && which < 5 ? v[which] : -1;
}

// One adafactor step in place over the table's T tensors in L leaves
// (``tiles`` tiles, ``entry_blocks`` blocks of moment entries and
// ``slices`` batch slices of factored tensors in all), clipped by the
// device norm [1] f32; ``pairs``: the (p, g) dtype pairs present, bit
// (p | g << 2) for each (0 = f32, 1 = bf16), one launch of each tile pass
// per pair. ``table``: device int64 [T, kFields] (see Field);
// ``leaves``: device int64 [L, 3] (first tile, tiles, elements);
// ``grads``: device int64 [T], the gradients' pointers; ``scratch``: f32,
// the partial sums of g^2 and the factors (at each tensor's kPF, kPS, kRF,
// kCF), then the tiles' sums of p^2 (at ``p2_at``) and of u^2 (at
// ``u2_at``) and the leaves' [denominator, scale] (at ``leaf_at``). The
// scalars are the plain version's f32 casts. Returns the CUDA error code
// of the launches (0 = launched).
extern "C" int kftpu_adafactor_update(const void* table, const void* leaves, const void* grads,
                                      int T, int L, int pairs, long long tiles,
                                      long long entry_blocks,
                                      long long slices, void* scratch, long long p2_at,
                                      long long u2_at, long long leaf_at, const void* norm,
                                      float max_norm, float decay, float keep, float lr,
                                      float wd, void* stream) {
  constexpr long long kMax = 1LL << 31;
  if (T <= 0 || L <= 0 || (pairs & ~51) || !pairs || tiles <= 0 || tiles >= kMax ||
      entry_blocks < 0 ||
      entry_blocks >= kMax || slices < 0 || slices >= kMax) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars s{max_norm, decay, keep, lr, wd};
  const long long* tab = static_cast<const long long*>(table);
  const long long* gp = static_cast<const long long*>(grads);
  const float* nrm = static_cast<const float*>(norm);
  float* scr = static_cast<float*>(scratch);
  const unsigned grid = static_cast<unsigned>(tiles);
  using B = __nv_bfloat16;
  // The dtype pairs present: bit (p | g << 2) of ``pairs``.
  const bool ff = pairs & 1, bf = pairs & 2, fb = pairs & 16, bb = pairs & 32;
  cudaError_t err;
  if (ff) tile_stats<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + p2_at);
  if (bf) tile_stats<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + p2_at);
  if (fb) tile_stats<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + p2_at);
  if (bb) tile_stats<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + p2_at);
  if (!launched(err)) return err;
  if (entry_blocks > 0) {
    moments<<<static_cast<unsigned>(entry_blocks), kThreads, 0, st>>>(tab, T, scr, s);
    if (!launched(err)) return err;
    row_factors<<<static_cast<unsigned>(slices), kThreads, 0, st>>>(tab, T, scr);
    if (!launched(err)) return err;
  }
  if (ff) tile_u2<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + u2_at);
  if (bf) tile_u2<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + u2_at);
  if (fb) tile_u2<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + u2_at);
  if (bb) tile_u2<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, scr + u2_at);
  if (!launched(err)) return err;
  leaf_sums<<<static_cast<unsigned>(L), kThreads, 0, st>>>(
      static_cast<const long long*>(leaves), scr + p2_at, scr + u2_at, scr + leaf_at);
  if (!launched(err)) return err;
  const float* lo = scr + leaf_at;
  if (ff) apply_update<float, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, lo);
  if (bf) apply_update<B, float><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, lo);
  if (fb) apply_update<float, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, lo);
  if (bb) apply_update<B, B><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, s, scr, lo);
  launched(err);
  return err;
}
