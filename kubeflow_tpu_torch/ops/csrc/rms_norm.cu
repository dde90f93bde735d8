// RMSNorm forward and backward for Hopper (sm_90a), and the same with the
// residual add in front (K10), bound to Python through a plain C interface
// (ctypes); see kubeflow_tpu_torch/ops/norms.py.
//
// Replaces the XLA fusion of kubeflow_tpu/ops/norms.py::rms_norm (:9), which
// jax.jit makes of its upcast, square, mean, rsqrt, two multiplies and cast
// (and of their transposes in the backward); and, with the add (K10), the
// fusion of ``x = x + h`` with the RMSNorm that reads it,
// kubeflow_tpu/models/llama.py:677-678 (and :680 into the next layer's
// :672, or the final norm). There is no Pallas kernel behind either.
//
// Function, per row of x [rows, E] (bf16 or f32) with weight w [E] (bf16 or
// f32): r = 1 / sqrt(mean(x^2) + eps) in f32, y = (x r) w rounded once to
// x's dtype; r is saved [rows] f32. Backward, with n = x r and g = dy w:
// dx = r (g - n mean(g n)) rounded once to x's dtype, dw = sum over rows of
// dy n in f32, rounded once to w's dtype. With the add, x is first the
// residual x + h rounded to x's dtype (written out, as the eager add
// writes it), and the backward adds the residual's incoming gradient dres:
// dx = dres + (the norm's dx, rounded), rounded again, as autograd's
// accumulation of the two rounds.
//
// Bound on this card: bytes. Forward reads x and writes y (4 bytes an
// element in bf16), backward reads x and dy and writes dx (6): at the
// training shape [24564, 2048] 60 and 90 us at 3.35 TB/s. With the add, the
// forward also reads h and writes the sum, the backward also reads dres
// (8 bytes an element each way): 120 us each.
//
// Design: one block of 256 threads a row; each thread holds its 16-byte
// chunks of the row in registers (kChunks of them, E up to 2048 kChunks
// elements), so x is read once. The row sum is a fixed-order block sum.
// The backward's dw is summed without atomics: block b takes a contiguous
// run of rows, keeps its columns' partial sums in registers and writes
// them to partial[b, E]; a second kernel adds the partials of each column
// in block order. Both are deterministic.
//
// At few rows (the serving forward's decode steps: 8 or 48 rows) a launch
// is a chain of latencies, not a stream of bytes: [8, 4096] moves 0.26 MB,
// 0.08 us at 3.35 TB/s, against some 3 us. The rows forward
// (rmsnorm_fwd_rows, add_rmsnorm_fwd_rows: their own names, so a profile
// tells them apart) shortens the chain: a block of E / 8 threads a row (up
// to 1024), one 16-byte chunk of x, h and w a thread, w's load issued with
// x's and h's instead of after the row sum, and one barrier in the row
// sum (every warp sums the warps' totals itself). The wrapper takes it up
// to ops/norms.py's ROWS_MAX rows.
//
// K10's combine mode (add_rmsnorm_fwd_rows_combine) also takes the place of
// moe.cu's K14 in front of the add: h is g1 ye[dest1] + g2 ye[dest2], the
// MoE layer's two expert rows weighted, rounded once. Its extra bytes are
// the two rows' chunks and 16 bytes a row; what it saves is K14's launch
// and its [rows, E] round trip through device memory. The row's choices
// and weights load with x and w, then the expert rows: one more dependent
// load than the rows kernel.

#include <type_traits>

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;

// The forward of one row a block. kAdd: x is x + h, rounded to T, and
// written to res (K10).
template <typename T, typename W, int kChunks, bool kAdd>
__device__ __forceinline__ void fwd_row(const T* __restrict__ x, const T* __restrict__ h,
                                        const W* __restrict__ w, T* __restrict__ res,
                                        T* __restrict__ y, float* __restrict__ rstd, int E,
                                        float eps, float* red) {
  const size_t row = blockIdx.x;
  const int nc = E / 8;
  const T* xr = x + row * E;
  float v[kChunks][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nc) {
      load8(xr + c * 8, v[i]);
      if (kAdd) {
        float hv[8];
        load8(h + row * E + c * 8, hv);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = rnd<T>(__fadd_rn(v[i][j], hv[j]));
        store8(res + row * E + c * 8, v[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += v[i][j] * v[i][j];
    }
  }
  const float var = block_sum<kThreads>(ss, red) / static_cast<float>(E);
  const float r = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nc) {
      float wv[8], o[8];
      load8(w + c * 8, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], r), wv[j]);
      store8(y + row * E + c * 8, o);
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

// The rows forward: one chunk a thread, blockDim.x = E / 8 rounded up to
// whole warps. kAdd: x is x + h, rounded to T, and written to res (K10).
constexpr int kRowsThreads = 1024;

// The rows forward's row sum and output from this thread's chunk v (x, or
// the residual) and w's chunk wv: each warp's butterfly, then every warp
// sums the warps' totals in warp order (a fixed order for a fixed block
// size).
template <typename T>
__device__ __forceinline__ void norm_one_chunk(const float (&v)[8], const float (&wv)[8],
                                               bool live, size_t at, T* __restrict__ y,
                                               float* __restrict__ rstd, int E, float eps) {
  __shared__ float red[kRowsThreads / 32];
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[threadIdx.x / 32] = ss;
  __syncthreads();
  float t = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  const float r = 1.f / sqrtf(t / static_cast<float>(E) + eps);
  if (live) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], r), wv[j]);
    store8(y + at, o);
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
}

template <typename T, typename W, bool kAdd>
__device__ __forceinline__ void fwd_one_chunk(const T* __restrict__ x, const T* __restrict__ h,
                                              const W* __restrict__ w, T* __restrict__ res,
                                              T* __restrict__ y, float* __restrict__ rstd,
                                              int E, float eps) {
  const size_t at = static_cast<size_t>(blockIdx.x) * E + threadIdx.x * 8;
  const bool live = static_cast<int>(threadIdx.x) < E / 8;
  float v[8] = {}, hv[8], wv[8];
  if (live) {                           // x, h and w in flight together
    load8(x + at, v);
    if (kAdd) load8(h + at, hv);
    load8(w + threadIdx.x * 8, wv);
  }
  if (live && kAdd) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = rnd<T>(__fadd_rn(v[j], hv[j]));
    store8(res + at, v);
  }
  norm_one_chunk<T>(v, wv, live, at, y, rstd, E, eps);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kRowsThreads)
    rmsnorm_fwd_rows(const T* __restrict__ x, const T* __restrict__ h, const W* __restrict__ w,
                     T* __restrict__ res, T* __restrict__ y, float* __restrict__ rstd, int E,
                     float eps) {
  fwd_one_chunk<T, W, false>(x, h, w, res, y, rstd, E, eps);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kRowsThreads)
    add_rmsnorm_fwd_rows(const T* __restrict__ x, const T* __restrict__ h,
                         const W* __restrict__ w, T* __restrict__ res, T* __restrict__ y,
                         float* __restrict__ rstd, int E, float eps) {
  fwd_one_chunk<T, W, true>(x, h, w, res, y, rstd, E, eps);
}

// K10's combine mode: h is K14's row (moe.cu's moe_combine), g1 ye[dest1] +
// g2 ye[dest2] in f32 rounded once to T, the expert outputs' row S read as
// 0; then the add and the norm as add_rmsnorm_fwd_rows. The row's choices
// and weights, x's and w's chunks are all loaded before any is used, then
// the two expert rows' chunks. Bitwise moe_combine then add_rmsnorm_fwd_rows.
template <typename T, typename W>
__global__ void __launch_bounds__(kRowsThreads)
    add_rmsnorm_fwd_rows_combine(const T* __restrict__ x, const T* __restrict__ ye,
                                 const float* __restrict__ g1, const float* __restrict__ g2,
                                 const int* __restrict__ dest1, const int* __restrict__ dest2,
                                 long long S, const W* __restrict__ w, T* __restrict__ res,
                                 T* __restrict__ y, float* __restrict__ rstd, int E, float eps) {
  const size_t row = blockIdx.x;
  const int col = threadIdx.x * 8;
  const size_t at = row * E + col;
  const bool live = static_cast<int>(threadIdx.x) < E / 8;
  const long long d1 = dest1[row], d2 = dest2[row];
  const float wa = g1[row], wb = g2[row];
  float v[8] = {}, wv[8], a[8] = {}, b[8] = {};
  if (live) {
    load8(x + at, v);
    load8(w + col, wv);
    if (d1 < S) load8(ye + d1 * E + col, a);
    if (d2 < S) load8(ye + d2 * E + col, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hj = rnd<T>(__fadd_rn(__fmul_rn(wa, a[j]), __fmul_rn(wb, b[j])));
      v[j] = rnd<T>(__fadd_rn(v[j], hj));
    }
    store8(res + at, v);
  }
  norm_one_chunk<T>(v, wv, live, at, y, rstd, E, eps);
}

template <typename T, typename W, int kChunks>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd(const T* __restrict__ x, const T* __restrict__ h, const W* __restrict__ w,
                T* __restrict__ res, T* __restrict__ y, float* __restrict__ rstd, int E,
                float eps) {
  __shared__ float red[kThreads / 32];
  fwd_row<T, W, kChunks, false>(x, h, w, res, y, rstd, E, eps, red);
}

// K10 under its own name, so a profile tells it from K6.
template <typename T, typename W, int kChunks>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_fwd(const T* __restrict__ x, const T* __restrict__ h, const W* __restrict__ w,
                    T* __restrict__ res, T* __restrict__ y, float* __restrict__ rstd, int E,
                    float eps) {
  __shared__ float red[kThreads / 32];
  fwd_row<T, W, kChunks, true>(x, h, w, res, y, rstd, E, eps, red);
}

// The backward of a run of rows a block. dres (may be null): the
// residual's incoming gradient, added to dx (K10).
template <typename T, typename W, int kChunks>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ x, const W* __restrict__ w,
                                         const T* __restrict__ dy, const T* __restrict__ dres,
                                         const float* __restrict__ rstd, T* __restrict__ dx,
                                         float* __restrict__ partial, long long rows, int E,
                                         long long rows_per_block, float* red) {
  const int nc = E / 8;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float wv[kChunks][8], acc[kChunks][8];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (c < nc) load8(w + c * 8, wv[i]);
  }
  for (long long row = r0; row < r1; ++row) {
    const float r = rstd[row];
    float n[kChunks][8], g[kChunks][8];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < nc) {
        float d[8];
        load8(x + row * E + c * 8, n[i]);
        load8(dy + row * E + c * 8, d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          n[i][j] = __fmul_rn(n[i][j], r);
          g[i][j] = __fmul_rn(d[j], wv[i][j]);
          dot += g[i][j] * n[i][j];
          acc[i][j] += d[j] * n[i][j];
        }
      }
    }
    const float mean = block_sum<kThreads>(dot, red) / static_cast<float>(E);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < nc) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = __fmul_rn(r, __fsub_rn(g[i][j], __fmul_rn(n[i][j], mean)));
        }
        if (dres != nullptr) {
          float d[8];
          load8(dres + row * E + c * 8, d);
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(d[j], rnd<T>(o[j]));
        }
        store8(dx + row * E + c * 8, o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nc) store8(partial + static_cast<size_t>(blockIdx.x) * E + c * 8, acc[i]);
  }
}

template <typename T, typename W, int kChunks>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                const T* __restrict__ dres, const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ partial, long long rows, int E, long long rows_per_block) {
  __shared__ float red[kThreads / 32];
  bwd_rows<T, W, kChunks>(x, w, dy, nullptr, rstd, dx, partial, rows, E, rows_per_block, red);
}

template <typename T, typename W, int kChunks>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_bwd(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                    const T* __restrict__ dres, const float* __restrict__ rstd,
                    T* __restrict__ dx, float* __restrict__ partial, long long rows, int E,
                    long long rows_per_block) {
  __shared__ float red[kThreads / 32];
  bwd_rows<T, W, kChunks>(x, w, dy, dres, rstd, dx, partial, rows, E, rows_per_block, red);
}

// dw[c] = sum over b of partial[b, c], b in order.
template <typename W>
__device__ __forceinline__ void dw_col(const float* __restrict__ partial, W* __restrict__ dw,
                                       int blocks, int E) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= E) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * E + c];
  store1(dw + c, s);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_dw(const float* __restrict__ partial, W* __restrict__ dw, int blocks, int E) {
  dw_col<W>(partial, dw, blocks, E);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_dw(const float* __restrict__ partial, W* __restrict__ dw, int blocks, int E) {
  dw_col<W>(partial, dw, blocks, E);
}

// The smallest chunk count a thread holds for width E, 0 if too wide.
int chunks_for(int E) {
  const int nc = E / 8;
  if (nc <= kThreads) return 1;
  if (nc <= 2 * kThreads) return 2;
  if (nc <= 4 * kThreads) return 4;
  return 0;
}

// h == nullptr: RMSNorm of x (K6); else of x + h, written to res (K10).
// by_rows: the rows forward (a chunk a thread), else a block of kThreads
// threads a row.
template <typename T, typename W>
cudaError_t fwd(bool by_rows, const void* x, const void* h, const void* w, void* res, void* y,
                float* rstd, long long rows, int E, float eps, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(rows));
  const int threads = by_rows ? (E / 8 + 31) / 32 * 32 : kThreads;
  auto args = [&](auto kernel) {
    kernel<<<grid, threads, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(h),
                                     static_cast<const W*>(w), static_cast<T*>(res),
                                     static_cast<T*>(y), rstd, E, eps);
  };
  const bool add = h != nullptr;
  if (by_rows) {
    add ? args(add_rmsnorm_fwd_rows<T, W>) : args(rmsnorm_fwd_rows<T, W>);
    return cudaGetLastError();
  }
  switch (chunks_for(E)) {
    case 1: add ? args(add_rmsnorm_fwd<T, W, 1>) : args(rmsnorm_fwd<T, W, 1>); break;
    case 2: add ? args(add_rmsnorm_fwd<T, W, 2>) : args(rmsnorm_fwd<T, W, 2>); break;
    case 4: add ? args(add_rmsnorm_fwd<T, W, 4>) : args(rmsnorm_fwd<T, W, 4>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// add: K10's kernels (dres may still be null: no residual gradient).
template <typename T, typename W>
cudaError_t bwd(bool add, const void* x, const void* w, const void* dy, const void* dres,
                const float* rstd, void* dx, void* dw, float* partial, long long rows, int E,
                int blocks, cudaStream_t st) {
  const long long per = (rows + blocks - 1) / blocks;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                       static_cast<const T*>(dy), static_cast<const T*>(dres),
                                       rstd, static_cast<T*>(dx), partial, rows, E, per);
  };
  switch (chunks_for(E)) {
    case 1: add ? args(add_rmsnorm_bwd<T, W, 1>) : args(rmsnorm_bwd<T, W, 1>); break;
    case 2: add ? args(add_rmsnorm_bwd<T, W, 2>) : args(rmsnorm_bwd<T, W, 2>); break;
    case 4: add ? args(add_rmsnorm_bwd<T, W, 4>) : args(rmsnorm_bwd<T, W, 4>); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (E + kThreads - 1) / kThreads;
  if (add) {
    add_rmsnorm_dw<W><<<grid, kThreads, 0, st>>>(partial, static_cast<W*>(dw), blocks, E);
  } else {
    rmsnorm_dw<W><<<grid, kThreads, 0, st>>>(partial, static_cast<W*>(dw), blocks, E);
  }
  return cudaGetLastError();
}

bool valid(int x_dtype, int w_dtype, long long rows, int E) {
  return (x_dtype == kF32 || x_dtype == kBF16) && (w_dtype == kF32 || w_dtype == kBF16) &&
         rows > 0 && rows < (1LL << 31) && E > 0 && E % 8 == 0 && chunks_for(E) > 0;
}

// The forward of either entry: h == nullptr for K6.
int fwd_entry(bool by_rows, int x_dtype, int w_dtype, const void* x, const void* h,
              const void* w, void* res, void* y, void* rstd, long long rows, int E, float eps,
              void* stream) {
  if (!valid(x_dtype, w_dtype, rows, E)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  using B = __nv_bfloat16;
  if (x_dtype == kBF16) {
    return w_dtype == kBF16 ? fwd<B, B>(by_rows, x, h, w, res, y, r, rows, E, eps, st)
                            : fwd<B, float>(by_rows, x, h, w, res, y, r, rows, E, eps, st);
  }
  return w_dtype == kBF16 ? fwd<float, B>(by_rows, x, h, w, res, y, r, rows, E, eps, st)
                          : fwd<float, float>(by_rows, x, h, w, res, y, r, rows, E, eps, st);
}

// K10's combine mode through the rows kernel (any rows).
int combine_entry(int x_dtype, int w_dtype, const void* x, const void* ye, const void* g1,
                  const void* g2, const void* dest1, const void* dest2, long long S,
                  const void* w, void* res, void* y, void* rstd, long long rows, int E, float eps,
                  void* stream) {
  if (!valid(x_dtype, w_dtype, rows, E) || S < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  const int threads = (E / 8 + 31) / 32 * 32;
  const float *a = static_cast<const float*>(g1), *b = static_cast<const float*>(g2);
  const int *d1 = static_cast<const int*>(dest1), *d2 = static_cast<const int*>(dest2);
  float* r = static_cast<float*>(rstd);
  auto launch = [&](auto* xt, auto* wt) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    using Wt = std::remove_const_t<std::remove_pointer_t<decltype(wt)>>;
    add_rmsnorm_fwd_rows_combine<T, Wt><<<grid, threads, 0, st>>>(
        xt, static_cast<const T*>(ye), a, b, d1, d2, S, wt, static_cast<T*>(res),
        static_cast<T*>(y), r, E, eps);
    return cudaGetLastError();
  };
  using B = __nv_bfloat16;
  if (x_dtype == kBF16) {
    return w_dtype == kBF16 ? launch(static_cast<const B*>(x), static_cast<const B*>(w))
                            : launch(static_cast<const B*>(x), static_cast<const float*>(w));
  }
  return w_dtype == kBF16 ? launch(static_cast<const float*>(x), static_cast<const B*>(w))
                          : launch(static_cast<const float*>(x), static_cast<const float*>(w));
}

// The backward of either entry (add: K10's).
int bwd_entry(bool add, int x_dtype, int w_dtype, const void* x, const void* w, const void* dy,
              const void* dres, const void* rstd, void* dx, void* dw, void* partial,
              long long rows, int E, int blocks, void* stream) {
  if (!valid(x_dtype, w_dtype, rows, E) || blocks < 1 || blocks > rows) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  using B = __nv_bfloat16;
  if (x_dtype == kBF16) {
    return w_dtype == kBF16
               ? bwd<B, B>(add, x, w, dy, dres, r, dx, dw, part, rows, E, blocks, st)
               : bwd<B, float>(add, x, w, dy, dres, r, dx, dw, part, rows, E, blocks, st);
  }
  return w_dtype == kBF16
             ? bwd<float, B>(add, x, w, dy, dres, r, dx, dw, part, rows, E, blocks, st)
             : bwd<float, float>(add, x, w, dy, dres, r, dx, dw, part, rows, E, blocks, st);
}

}  // namespace

// y = rms_norm(x, w), rstd [rows] f32. x, w, y contiguous and 16-byte
// aligned; dtypes 0 = f32, 1 = bf16 (y has x's). Returns the CUDA error code
// of the launch (0 = launched).
extern "C" int kftpu_rms_norm_fwd(int x_dtype, int w_dtype, const void* x, const void* w, void* y,
                                  void* rstd, long long rows, int E, float eps, void* stream) {
  return fwd_entry(false, x_dtype, w_dtype, x, nullptr, w, nullptr, y, rstd, rows, E, eps,
                   stream);
}

// The same through the rows forward (one chunk a thread; any rows).
extern "C" int kftpu_rms_norm_fwd_rows(int x_dtype, int w_dtype, const void* x, const void* w,
                                       void* y, void* rstd, long long rows, int E, float eps,
                                       void* stream) {
  return fwd_entry(true, x_dtype, w_dtype, x, nullptr, w, nullptr, y, rstd, rows, E, eps,
                   stream);
}

// dx [rows, E] (x's dtype) and dw [E] (w's dtype) from x, w, dy and the
// forward's rstd. ``partial``: [blocks, E] f32 scratch, ``blocks`` the row
// runs dw is summed over (1 .. rows). Returns the CUDA error code.
extern "C" int kftpu_rms_norm_bwd(int x_dtype, int w_dtype, const void* x, const void* w,
                                  const void* dy, const void* rstd, void* dx, void* dw,
                                  void* partial, long long rows, int E, int blocks,
                                  void* stream) {
  return bwd_entry(false, x_dtype, w_dtype, x, w, dy, nullptr, rstd, dx, dw, partial, rows, E,
                   blocks, stream);
}

// K10: res = x + h rounded to x's dtype, y = rms_norm(res, w), rstd [rows]
// f32; x, h, res and y of one dtype, contiguous and 16-byte aligned.
// Returns the CUDA error code of the launch.
extern "C" int kftpu_add_rms_norm_fwd(int x_dtype, int w_dtype, const void* x, const void* h,
                                      const void* w, void* res, void* y, void* rstd,
                                      long long rows, int E, float eps, void* stream) {
  if (h == nullptr || res == nullptr) return cudaErrorInvalidValue;
  return fwd_entry(false, x_dtype, w_dtype, x, h, w, res, y, rstd, rows, E, eps, stream);
}

// K10 through the rows forward (one chunk a thread; any rows).
extern "C" int kftpu_add_rms_norm_fwd_rows(int x_dtype, int w_dtype, const void* x,
                                           const void* h, const void* w, void* res, void* y,
                                           void* rstd, long long rows, int E, float eps,
                                           void* stream) {
  if (h == nullptr || res == nullptr) return cudaErrorInvalidValue;
  return fwd_entry(true, x_dtype, w_dtype, x, h, w, res, y, rstd, rows, E, eps, stream);
}

// K10's combine mode: res = x + h rounded to x's dtype, y = rms_norm(res,
// w), rstd [rows] f32, where h [rows, E] = g1 ye[dest1] + g2 ye[dest2] in f32
// rounded to x's dtype (K14's rows; ye [S, E] in x's dtype, row S read as
// 0; g1, g2 f32 and dest1, dest2 int32 [rows]). Returns the CUDA error code
// of the launch.
extern "C" int kftpu_add_rms_norm_fwd_combine(int x_dtype, int w_dtype, const void* x,
                                              const void* ye, const void* g1, const void* g2,
                                              const void* dest1, const void* dest2,
                                              long long S, const void* w, void* res, void* y,
                                              void* rstd, long long rows, int E, float eps,
                                              void* stream) {
  return combine_entry(x_dtype, w_dtype, x, ye, g1, g2, dest1, dest2, S, w, res, y, rstd, rows,
                       E, eps, stream);
}

// K10's backward: dx = dres + rms_norm's dx of res (each rounded to the
// dtype; dres may be null: no residual gradient) and dw, from res, w, dy
// and the forward's rstd; ``partial`` and ``blocks`` as kftpu_rms_norm_bwd.
extern "C" int kftpu_add_rms_norm_bwd(int x_dtype, int w_dtype, const void* res, const void* w,
                                      const void* dy, const void* dres, const void* rstd,
                                      void* dx, void* dw, void* partial, long long rows, int E,
                                      int blocks, void* stream) {
  return bwd_entry(true, x_dtype, w_dtype, res, w, dy, dres, rstd, dx, dw, partial, rows, E,
                   blocks, stream);
}
