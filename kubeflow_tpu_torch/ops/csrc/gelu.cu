// Bias add + GELU (tanh form) forward and backward (K21), for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/ops/gelu.py.
//
// Replaces the XLA fusion of the ViT MLP's ``mlp_in`` bias add with
// ``nn.gelu`` (kubeflow_tpu/models/vit.py:96-97), and of its autodiff. There
// is no Pallas kernel behind it. The product itself stays a library GEMM
// (F.linear, no bias): JAX's bf16 Dense adds its bias after the product is
// rounded, which a GEMM's fused bias epilogue does not do, so the bias comes
// here.
//
// Function, per element of x [rows, F] (bf16 or f32) with bias b [F] in x's
// dtype: h = x + b rounded to the dtype; y = gelu(h) with nn.gelu's default
// tanh approximation (not torch's default exact erf), with JAX's constants
// in the dtype (c1 = sqrt(2 / pi), c2 = 0.044715, rounded to bf16 for bf16)
// and every operation rounded to the dtype, as jax.nn.gelu runs on bf16:
// u = ((h h) h) c2, v = (h + u) c1, t = tanh(v), y = h ((1 + t) 0.5).
// Backward: with t of h as above, dh = dy (0.5 (1 + t) + 0.5 h (1 - t^2)
// c1 (1 + 3 c2 h^2)) in f32, rounded once to the dtype; it is x's gradient,
// and the bias's gradient is its sum over the rows in f32, rounded once.
//
// Bound on this card: bytes. The forward reads x and writes y (4 bytes an
// element in bf16), the backward reads x and dy and writes dh (6): at
// ViT-B/16's mlp_in [64 x 197, 3072] 29 and 43 us at 3.35 TB/s.
//
// Design: forward and backward in colsum_common.cuh's row-run layout (a
// block a run of rows and a tile of up to 256 chunks of 8, each thread's
// bias chunk in registers, no index division an element); the backward's
// column sums of dh as per-block partials and one fixed-order sum: no
// atomics, two calls bitwise equal.

#include "colsum_common.cuh"

namespace {

using namespace kftpu_colsum;

// gelu of h (already rounded to T), every operation rounded to T.
template <typename T>
__device__ __forceinline__ float gelu_of(float h, float c1, float c2) {
  const float u = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(h, h)), h)), c2));
  const float v = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(h, u)), c1));
  const float t = rnd<T>(tanhf(v));
  return rnd<T>(__fmul_rn(h, rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(1.f, t)), 0.5f))));
}

// d gelu / dh at h, in f32.
__device__ __forceinline__ float gelu_grad(float h, float c1, float c2) {
  const float h2 = __fmul_rn(h, h);
  const float t = tanhf(__fmul_rn(__fadd_rn(h, __fmul_rn(__fmul_rn(h2, h), c2)), c1));
  const float left = __fmul_rn(0.5f, __fadd_rn(1.f, t));
  const float sech2 = __fsub_rn(1.f, __fmul_rn(t, t));
  const float inner = __fmul_rn(c1, __fadd_rn(1.f, __fmul_rn(__fmul_rn(3.f, c2), h2)));
  return __fadd_rn(left, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, h), sech2), inner));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_fwd(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y, long long rows,
             int F, long long per, float c1, float c2) {
  const Tile t = tile_of<8>(rows, F, per);
  if (!t.live) return;
  float bv[8];
  load8(b + t.col, bv);
#pragma unroll 2
  for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
    const size_t at = static_cast<size_t>(r) * F + t.col;
    float v[8];
    load8(x + at, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gelu_of<T>(rnd<T>(__fadd_rn(v[j], bv[j])), c1, c2);
    store8(y + at, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_bwd(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ dy,
             T* __restrict__ dh, float* __restrict__ partial, long long rows, int F,
             long long per, float c1, float c2) {
  const Tile t = tile_of<8>(rows, F, per);
  // A thread's own rows are summed plainly (a few dozen a thread; with a
  // compensation term the f32 instantiation spilled); the block's lanes
  // and the partials are added compensated (colsum_common.cuh).
  float acc[1][8] = {};
  if (t.live) {
    float bv[8];
    load8(b + t.col, bv);
#pragma unroll 2
    for (long long r = t.r0 + t.lane; r < t.r1; r += t.rp) {
      const size_t at = static_cast<size_t>(r) * F + t.col;
      float v[8], d[8];
      load8(x + at, v);
      load8(dy + at, d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float h = rnd<T>(__fadd_rn(v[j], bv[j]));
        v[j] = rnd<T>(__fmul_rn(d[j], gelu_grad(h, c1, c2)));
        acc[0][j] += v[j];
      }
      store8(dh + at, v);
    }
  }
  write_partials<8, 1>(t, acc, partial, F);
}

template <typename T>
__global__ void __launch_bounds__(kFinishCols * kFinishLanes)
    gelu_dbias(const float* __restrict__ partial, int P, int F, T* __restrict__ db) {
  float tot[1];
  const int c = finish_sums<1>(partial, P, F, tot);
  if (c >= 0) store1(db + c, tot[0]);
}

bool valid(int dtype, long long rows, int F) {
  return (dtype == kF32 || dtype == kBF16) && rows > 0 && F > 0 && F % 8 == 0;
}

template <typename T>
cudaError_t fwd(const void* x, const void* b, void* y, long long rows, int F, int P, float c1,
                float c2, cudaStream_t st) {
  gelu_fwd<T><<<grid_of<8>(F, P), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), rows, F,
      per_run(rows, P), c1, c2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* b, const void* dy, void* dh, void* db, float* partial,
                long long rows, int F, int P, float c1, float c2, cudaStream_t st) {
  gelu_bwd<T><<<grid_of<8>(F, P), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(dy),
      static_cast<T*>(dh), partial, rows, F, per_run(rows, P), c1, c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gelu_dbias<T><<<finish_grid(F), finish_block(), 0, st>>>(partial, P, F, static_cast<T*>(db));
  return cudaGetLastError();
}

}  // namespace

// y = gelu(x + b) [rows, F] (x's dtype); x, y contiguous and 16-byte
// aligned, b [F] in x's dtype, F a multiple of 8; c1, c2 the tanh form's
// constants in the dtype. ``blocks``: the row runs (1 .. min(rows,
// 65535)). dtype 0 = f32, 1 = bf16. Returns the CUDA error code of the
// launch.
extern "C" int kftpu_bias_gelu_fwd(int dtype, const void* x, const void* b, void* y,
                                   long long rows, int F, int blocks, float c1, float c2,
                                   void* stream) {
  if (!valid(dtype, rows, F) || blocks < 1 || blocks > rows || blocks > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? fwd<__nv_bfloat16>(x, b, y, rows, F, blocks, c1, c2, st)
                        : fwd<float>(x, b, y, rows, F, blocks, c1, c2, st);
}

// dh [rows, F] (x's dtype) and db [F] (x's dtype) from x, b and dy.
// ``partial``: [blocks, F] f32 scratch, ``blocks`` the row runs (1 ..
// min(rows, 65535)). Returns the CUDA error code of the launches.
extern "C" int kftpu_bias_gelu_bwd(int dtype, const void* x, const void* b, const void* dy,
                                   void* dh, void* db, void* partial, long long rows, int F,
                                   int blocks, float c1, float c2, void* stream) {
  if (!valid(dtype, rows, F) || blocks < 1 || blocks > rows || blocks > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  return dtype == kBF16 ? bwd<__nv_bfloat16>(x, b, dy, dh, db, pa, rows, F, blocks, c1, c2, st)
                        : bwd<float>(x, b, dy, dh, db, pa, rows, F, blocks, c1, c2, st);
}
