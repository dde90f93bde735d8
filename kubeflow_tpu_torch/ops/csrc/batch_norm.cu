// BatchNorm with flax's semantics, forward and backward, with an optional
// residual add and ReLU in the same launch (K19), for Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/ops/batch_norm.py.
//
// Replaces the XLA fusions of flax nn.BatchNorm (momentum 0.9, epsilon 1e-5,
// use_fast_variance) with the nn.relu after it, and at a bottleneck block's
// end with ``relu(y + residual)``: kubeflow_tpu/models/resnet.py:66-76
// (_bn), :85-104 (bn1, bn2, bn3, bn_proj) and :124-125 (bn_init). There is
// no Pallas kernel behind them.
//
// Function, per channel c of the channels-last activation x seen as [rows,
// C] (bf16 or f32), scale and bias f32 [C]:
//   training: mean = E[x], var = max(0, E[x^2] - mean^2) in f32 over the
//     rows; the running statistics become kOld ra + kNew stat (flax's
//     momentum is the OLD value's weight: kOld = 0.9, kNew = 0.1; the
//     variance is the biased one);
//   eval: mean and var are the running statistics, which stay as they are;
//   y = (x - mean) (rsqrt(var + kEps) scale) + bias in f32 in flax
//     _normalize's order, rounded once to x's dtype; then, per call,
//     y + residual rounded again (the bf16 add) and ReLU.
// Backward, with g = dy where the output is > 0 (JAX's ReLU gradient at 0
// is 0; g = dy without ReLU) and xh = (x - mean) rstd: dbias = sum g,
// dscale = sum g xh over the rows (f32); in training dx = rstd scale (g -
// dbias / N - xh dscale / N), in eval dx = rstd scale g, rounded once to
// x's dtype; the residual's gradient is g.
//
// Bound on this card: bytes. The training forward must read x (and the
// residual) and write y: 4 bytes an element in bf16 (6 with the residual);
// the backward reads x, dy and (with ReLU) the output and writes dx (and
// the residual's gradient). At ResNet-50's stem at batch 256, [3211264, 64]
// bf16, the forward's 822 MB take 0.245 ms at 3.35 TB/s.
//
// Design: three passes, no atomics. (1) Per-block partial sums: block b of
// P takes a contiguous run of rows and a tile of up to 256 chunks of V
// channels (V = 8, 16-byte accesses, when C % 8 == 0; else V = 1); its
// threads are rp = 256 / tile rows in parallel, each summing its channels
// over its rows in f32 (compensated sums), then the block adds its row
// lanes in lane order and writes partial[b, C]. (2) bn_finish: a block of 32 channels x 32 lanes
// adds the P partials of each channel, lane l taking b = l, l + 32, ..., then
// the lanes in order: a fixed order for a fixed P, so two calls are bitwise
// equal; it forms the statistics (and updates the running ones) or the
// backward's sums. (3) An element-wise pass in the same thread layout, each
// thread's channel constants in registers. x is read twice (the statistics
// and the apply), which the design accepts: a first version; the stage
// activations (51-411 MB) do not fit the 50 MB L2 between the passes.

#include "colsum_common.cuh"

namespace {

using namespace kftpu_colsum;

// flax nn.BatchNorm's defaults as the JAX ResNet takes them (batch_norm.py's
// MOMENTUM and EPS): the running statistics keep kOld of the old value and
// take kNew (1 - 0.9 in double, rounded to f32: 0.1f) of the batch's.
constexpr float kOld = 0.9f;
constexpr float kNew = 0.1f;
constexpr float kEps = 1e-5f;

// (1) Forward: per-block sums of x and x^2 over a run of rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_partial(const T* __restrict__ x, float* __restrict__ partial, long long rows, int C,
                     long long per) {
  const Tile t = tile_of<V>(rows, C, per);
  float acc[2][V] = {}, comp[2][V] = {};
  if (t.live) {
    const T* p = x + t.col;
#pragma unroll 4
    for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
      float v[V];
      loadv<T, V>(p + r * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        kahan_add(acc[0][j], comp[0][j], v[j]);
        kahan_add(acc[1][j], comp[1][j], __fmul_rn(v[j], v[j]));
      }
    }
  }
  write_partials<V, 2>(t, acc, partial, C);
}

// (2) The partials' fixed-order sum, a channel a column of threads.
// kBackward false: mean = s / N, var = max(0, q / N - mean^2) into o0, o1,
// and (update) the running statistics. kBackward true: dbias = s, dscale = q
// into o0, o1, and ab[0, c] = s / N, ab[1, c] = q / N for the dx pass.
template <bool kBackward>
__global__ void __launch_bounds__(kFinishCols * kFinishLanes)
    bn_finish(const float* __restrict__ partial, int P, int C, long long rows,
              float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ ra_mean,
              float* __restrict__ ra_var, float* __restrict__ ab) {
  float tot[2];
  const int c = finish_sums<2>(partial, P, C, tot);
  if (c < 0) return;
  const float s = tot[0], q = tot[1];
  const float n = static_cast<float>(rows);
  if (kBackward) {
    o0[c] = s;
    o1[c] = q;
    ab[c] = __fdiv_rn(s, n);
    ab[C + c] = __fdiv_rn(q, n);
    return;
  }
  const float mean = __fdiv_rn(s, n);
  const float d = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;          // NaN stays NaN, as jnp.maximum
  o0[c] = mean;
  o1[c] = var;
  if (ra_mean != nullptr) {
    ra_mean[c] = __fadd_rn(__fmul_rn(kOld, ra_mean[c]), __fmul_rn(kNew, mean));
    ra_var[c] = __fadd_rn(__fmul_rn(kOld, ra_var[c]), __fmul_rn(kNew, var));
  }
}

__device__ __forceinline__ float rstd_of(float var) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps)));
}

// (3) Forward apply: y = (x - mean) (rstd scale) + bias rounded to T; then
// kRes: y + residual rounded to T; kRelu: max(y, 0) (NaN stays NaN, -0
// becomes 0, as torch.relu).
template <typename T, int V, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_apply(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ scale,
             const float* __restrict__ bias, T* __restrict__ y, long long rows, int C,
             long long per) {
  const Tile t = tile_of<V>(rows, C, per);
  if (!t.live) return;
  float m[V], k[V], b[V];
  loadc<float, V>(mean, t.col, m);
  loadc<float, V>(var, t.col, k);
  loadc<float, V>(bias, t.col, b);
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = __fmul_rn(rstd_of(k[j]), scale[t.col + j]);
#pragma unroll 2
  for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
    const size_t at = static_cast<size_t>(r) * C + t.col;
    float v[V], rv[V];
    loadv<T, V>(x + at, v);
    if (kRes) loadv<T, V>(res + at, rv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float o = rnd<T>(__fadd_rn(__fmul_rn(__fsub_rn(v[j], m[j]), k[j]), b[j]));
      if (kRes) o = rnd<T>(__fadd_rn(o, rv[j]));
      if (kRelu) o = (o > 0.f || o != o) ? o : 0.f;
      v[j] = o;
    }
    storev<T, V>(y + at, v);
  }
}

// The backward's incoming gradient of one element: dy, or 0 where the
// ReLU's output is not > 0.
template <bool kRelu>
__device__ __forceinline__ float masked(float d, float out) {
  return (!kRelu || out > 0.f) ? d : 0.f;
}

// (1) Backward: per-block sums of g and g xh over a run of rows.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partial(const T* __restrict__ x, const T* __restrict__ out, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ var,
                   float* __restrict__ partial, long long rows, int C, long long per) {
  const Tile t = tile_of<V>(rows, C, per);
  float acc[2][V] = {}, comp[2][V] = {};
  if (t.live) {
    float m[V], rs[V];
    loadc<float, V>(mean, t.col, m);
    loadc<float, V>(var, t.col, rs);
#pragma unroll
    for (int j = 0; j < V; ++j) rs[j] = rstd_of(rs[j]);
#pragma unroll 2
    for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
      const size_t at = static_cast<size_t>(r) * C + t.col;
      float v[V], d[V], o[V];
      loadv<T, V>(x + at, v);
      loadv<T, V>(dy + at, d);
      if (kRelu) loadv<T, V>(out + at, o);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float g = masked<kRelu>(d[j], kRelu ? o[j] : 1.f);
        kahan_add(acc[0][j], comp[0][j], g);
        kahan_add(acc[1][j], comp[1][j],
                  __fmul_rn(g, __fmul_rn(__fsub_rn(v[j], m[j]), rs[j])));
      }
    }
  }
  write_partials<V, 2>(t, acc, partial, C);
}

// (3) Backward dx (and the residual's gradient g when kRes).
template <typename T, int V, bool kRelu, bool kRes, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_dx(const T* __restrict__ x, const T* __restrict__ out, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ scale, const float* __restrict__ ab, T* __restrict__ dx,
              T* __restrict__ dres, long long rows, int C, long long per) {
  const Tile t = tile_of<V>(rows, C, per);
  if (!t.live) return;
  float m[V], rs[V], k[V], a[V], b[V];
  loadc<float, V>(mean, t.col, m);
  loadc<float, V>(var, t.col, rs);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    rs[j] = rstd_of(rs[j]);
    k[j] = __fmul_rn(rs[j], scale[t.col + j]);
    a[j] = kTrain ? ab[t.col + j] : 0.f;
    b[j] = kTrain ? ab[C + t.col + j] : 0.f;
  }
#pragma unroll 2
  for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
    const size_t at = static_cast<size_t>(r) * C + t.col;
    float v[V], d[V], o[V];
    loadv<T, V>(dy + at, d);
    if (kTrain) loadv<T, V>(x + at, v);
    if (kRelu) loadv<T, V>(out + at, o);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      d[j] = masked<kRelu>(d[j], kRelu ? o[j] : 1.f);
      float e = d[j];
      if (kTrain) {
        const float xh = __fmul_rn(__fsub_rn(v[j], m[j]), rs[j]);
        e = __fsub_rn(__fsub_rn(d[j], a[j]), __fmul_rn(xh, b[j]));
      }
      v[j] = __fmul_rn(k[j], e);
    }
    storev<T, V>(dx + at, v);
    if (kRes) storev<T, V>(dres + at, d);
  }
}

// The launch shapes of the row-run kernels: P blocks of row runs by the
// channel tiles.
struct Grid {
  dim3 grid;
  long long per;
};

template <int V>
Grid launch_of(long long rows, int C, int P) {
  return {grid_of<V>(C, P), per_run(rows, P)};
}

void finish(bool backward, const float* partial, int P, int C, long long rows, float* o0,
            float* o1, float* ra_mean, float* ra_var, float* ab, cudaStream_t st) {
  const dim3 grid = finish_grid(C), block = finish_block();
  if (backward) {
    bn_finish<true><<<grid, block, 0, st>>>(partial, P, C, rows, o0, o1, nullptr, nullptr, ab);
  } else {
    bn_finish<false><<<grid, block, 0, st>>>(partial, P, C, rows, o0, o1, ra_mean, ra_var,
                                             nullptr);
  }
}

template <typename T, int V>
cudaError_t forward(bool train, bool relu, const void* x, const void* res, const float* scale,
                    const float* bias, float* ra_mean, float* ra_var, float* mean, float* var,
                    void* y, float* partial, long long rows, int C, int P, cudaStream_t st) {
  const Grid g = launch_of<V>(rows, C, P);
  const T* xt = static_cast<const T*>(x);
  if (train) {
    bn_stats_partial<T, V><<<g.grid, kThreads, 0, st>>>(xt, partial, rows, C, g.per);
    finish(false, partial, P, C, rows, mean, var, ra_mean, ra_var, nullptr, st);
  } else {
    mean = ra_mean;
    var = ra_var;
  }
  auto args = [&](auto kernel) {
    kernel<<<g.grid, kThreads, 0, st>>>(xt, static_cast<const T*>(res), mean, var, scale, bias,
                                        static_cast<T*>(y), rows, C, g.per);
  };
  if (res != nullptr) {
    relu ? args(bn_apply<T, V, true, true>) : args(bn_apply<T, V, true, false>);
  } else {
    relu ? args(bn_apply<T, V, false, true>) : args(bn_apply<T, V, false, false>);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t backward(bool train, bool relu, const void* x, const void* out, const void* dy,
                     const float* mean, const float* var, const float* scale, float* dscale,
                     float* dbias, void* dx, void* dres, float* partial, float* ab,
                     long long rows, int C, int P, cudaStream_t st) {
  const Grid g = launch_of<V>(rows, C, P);
  const T *xt = static_cast<const T*>(x), *ot = static_cast<const T*>(out),
          *dt = static_cast<const T*>(dy);
  if (relu) {
    bn_bwd_partial<T, V, true><<<g.grid, kThreads, 0, st>>>(xt, ot, dt, mean, var, partial, rows,
                                                            C, g.per);
  } else {
    bn_bwd_partial<T, V, false><<<g.grid, kThreads, 0, st>>>(xt, ot, dt, mean, var, partial,
                                                             rows, C, g.per);
  }
  finish(true, partial, P, C, rows, dbias, dscale, nullptr, nullptr, ab, st);
  auto args = [&](auto kernel) {
    kernel<<<g.grid, kThreads, 0, st>>>(xt, ot, dt, mean, var, scale, ab, static_cast<T*>(dx),
                                        static_cast<T*>(dres), rows, C, g.per);
  };
  const bool r = dres != nullptr;
  // (relu, residual, train): the eight dx kernels.
  const int which = (relu ? 4 : 0) | (r ? 2 : 0) | (train ? 1 : 0);
  switch (which) {
    case 0: args(bn_bwd_dx<T, V, false, false, false>); break;
    case 1: args(bn_bwd_dx<T, V, false, false, true>); break;
    case 2: args(bn_bwd_dx<T, V, false, true, false>); break;
    case 3: args(bn_bwd_dx<T, V, false, true, true>); break;
    case 4: args(bn_bwd_dx<T, V, true, false, false>); break;
    case 5: args(bn_bwd_dx<T, V, true, false, true>); break;
    case 6: args(bn_bwd_dx<T, V, true, true, false>); break;
    default: args(bn_bwd_dx<T, V, true, true, true>); break;
  }
  return cudaGetLastError();
}

bool valid(int dtype, long long rows, int C, int P) {
  return (dtype == kF32 || dtype == kBF16) && rows > 0 && C > 0 && P > 0 && P <= rows &&
         P < 65536;
}

// V = 8 when every row's chunks are 16-byte aligned; the wrapper passes
// 16-byte aligned tensors.
bool vec8(int C) { return C % 8 == 0; }

}  // namespace

// y [rows, C] (x's dtype) = batch_norm(x) (+ res) (ReLU). train: the batch
// statistics into mean, var [C] f32 and the running ones updated in place
// (ra = kOld ra + kNew stat); else the running ones are used and nothing
// is written but y. res may be null. ``partial``: [2, blocks, C] f32 scratch
// (training), ``blocks`` the row runs (1 .. min(rows, 65535)). dtype 0 = f32,
// 1 = bf16. Returns the CUDA error code of the launches (0 = launched).
extern "C" int kftpu_batch_norm_fwd(int dtype, int train, int relu, const void* x,
                                    const void* res, const void* scale, const void* bias,
                                    void* ra_mean, void* ra_var, void* mean, void* var, void* y,
                                    void* partial, long long rows, int C, int blocks,
                                    void* stream) {
  if (!valid(dtype, rows, C, blocks)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *sc = static_cast<const float*>(scale), *bi = static_cast<const float*>(bias);
  float *rm = static_cast<float*>(ra_mean), *rv = static_cast<float*>(ra_var),
        *mn = static_cast<float*>(mean), *vr = static_cast<float*>(var),
        *pa = static_cast<float*>(partial);
  using B = __nv_bfloat16;
  if (dtype == kBF16) {
    return vec8(C) ? forward<B, 8>(train, relu, x, res, sc, bi, rm, rv, mn, vr, y, pa, rows, C,
                                   blocks, st)
                   : forward<B, 1>(train, relu, x, res, sc, bi, rm, rv, mn, vr, y, pa, rows, C,
                                   blocks, st);
  }
  return vec8(C) ? forward<float, 8>(train, relu, x, res, sc, bi, rm, rv, mn, vr, y, pa, rows, C,
                                     blocks, st)
                 : forward<float, 1>(train, relu, x, res, sc, bi, rm, rv, mn, vr, y, pa, rows, C,
                                     blocks, st);
}

// dx [rows, C] (x's dtype), dscale and dbias [C] f32 from x, the forward's
// output (read for the ReLU mask; may be null without ReLU), dy and the
// statistics the forward used (mean, var [C] f32: the batch's in training,
// the running ones in eval), scale [C] f32. dres (may be null): the
// residual's gradient, g. ``partial``: [2, blocks, C] f32 scratch, ``ab``:
// [2, C] f32 scratch. Returns the CUDA error code of the launches.
extern "C" int kftpu_batch_norm_bwd(int dtype, int train, int relu, const void* x,
                                    const void* out, const void* dy, const void* mean,
                                    const void* var, const void* scale, void* dscale,
                                    void* dbias, void* dx, void* dres, void* partial, void* ab,
                                    long long rows, int C, int blocks, void* stream) {
  if (!valid(dtype, rows, C, blocks) || (relu && out == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *mn = static_cast<const float*>(mean), *vr = static_cast<const float*>(var),
              *sc = static_cast<const float*>(scale);
  float *ds = static_cast<float*>(dscale), *db = static_cast<float*>(dbias),
        *pa = static_cast<float*>(partial), *a = static_cast<float*>(ab);
  using B = __nv_bfloat16;
  if (dtype == kBF16) {
    return vec8(C) ? backward<B, 8>(train, relu, x, out, dy, mn, vr, sc, ds, db, dx, dres, pa, a,
                                    rows, C, blocks, st)
                   : backward<B, 1>(train, relu, x, out, dy, mn, vr, sc, ds, db, dx, dres, pa, a,
                                    rows, C, blocks, st);
  }
  return vec8(C) ? backward<float, 8>(train, relu, x, out, dy, mn, vr, sc, ds, db, dx, dres, pa,
                                      a, rows, C, blocks, st)
                 : backward<float, 1>(train, relu, x, out, dy, mn, vr, sc, ds, db, dx, dres, pa,
                                      a, rows, C, blocks, st);
}
