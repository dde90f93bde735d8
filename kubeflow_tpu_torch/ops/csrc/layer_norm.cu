// LayerNorm with flax's semantics, forward and backward (K20), for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/ops/layer_norm.py.
//
// Replaces the XLA fusion of flax nn.LayerNorm (epsilon 1e-6, not torch's
// 1e-5; use_fast_variance) at kubeflow_tpu/models/vit.py:80 (ln1), :94 (ln2)
// and :153 (ln_final), and of its autodiff. There is no Pallas kernel
// behind it.
//
// Function, per row of x [rows, E] (bf16 or f32) with scale and bias f32
// [E]: mean = E[x], var = max(0, E[x^2] - mean^2) and rstd = 1 / sqrt(var +
// kEps) in f32; y = (x - mean) (rstd scale) + bias in f32 in flax
// _normalize's order, rounded once to x's dtype; mean and rstd are saved
// [rows] f32. Backward, with xh = (x - mean) rstd and g = dy scale: dx =
// rstd ((g - mean(g)) - xh mean(g xh)) rounded once to x's dtype; dscale =
// sum over rows of dy xh, dbias = sum of dy, f32.
//
// Bound on this card: bytes. The forward reads x and writes y (4 bytes an
// element in bf16), the backward reads x and dy and writes dx (6): at
// ViT-B/16's [64 x 197, 768] 7.2 and 10.8 us at 3.35 TB/s.
//
// Design: K6's (rms_norm.cu) with a mean and a bias, a warp a row: each
// lane holds its 16-byte chunks of the row in registers (kChunks of them,
// E up to 256 kChunks; ViT widths 768 and 1024 take 3 and 4 chunks a lane),
// the row sums are the warp's butterfly (no shared memory, no barrier), and
// a block of 8 warps takes 8 rows. The backward's dscale and dbias are
// summed without atomics: block b takes a contiguous run of rows (its warps
// interleaved), keeps its lanes' column sums in registers, adds its warps'
// in warp order in shared memory and writes partial[2, b, E]; a second
// kernel adds the partials of each column in a fixed order
// (colsum_common.cuh's finish_sums).

#include "colsum_common.cuh"

namespace {

using namespace kftpu_fused;

// flax nn.LayerNorm's epsilon (layer_norm.py's EPS).
constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kBlock)
    ln_fwd(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
           float* __restrict__ rstd_out, long long rows, int E) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int nc = E / 8;
  const T* xr = x + row * E;
  float v[kChunks][8];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      load8(xr + c * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += v[i][j];
        q += v[i][j] * v[i][j];
      }
    }
  }
  const float n = static_cast<float>(E);
  const float mean = __fdiv_rn(warp_sum(s), n);
  const float d = __fsub_rn(__fdiv_rn(warp_sum(q), n), __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;            // NaN stays NaN, as jnp.maximum
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps)));
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      float sc[8], bi[8], o[8];
      load8(scale + c * 8, sc);
      load8(bias + c * 8, bi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[i][j], mean), __fmul_rn(r, sc[j])), bi[j]);
      }
      store8(y + row * E + c * 8, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = r;
  }
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kBlock)
    ln_bwd(const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
           const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
           float* __restrict__ partial, long long rows, int E, long long per) {
  __shared__ float red[2][kChunks * 256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = E / 8;
  const long long r0 = static_cast<long long>(blockIdx.x) * per;
  const long long r1 = min(rows, r0 + per);
  const float n = static_cast<float>(E);
  float sc[kChunks][8], ds[kChunks][8], db[kChunks][8];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[i][j] = db[i][j] = 0.f;
    if (c < nc) load8(scale + c * 8, sc[i]);
  }
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    const float m = mean[row], r = rstd[row];
    float xh[kChunks][8], g[kChunks][8];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        float d[8];
        load8(x + row * E + c * 8, xh[i]);
        load8(dy + row * E + c * 8, d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[i][j] = __fmul_rn(__fsub_rn(xh[i][j], m), r);
          g[i][j] = __fmul_rn(d[j], sc[i][j]);
          sg += g[i][j];
          sgx += g[i][j] * xh[i][j];
          ds[i][j] += d[j] * xh[i][j];
          db[i][j] += d[j];
        }
      }
    }
    const float a = __fdiv_rn(warp_sum(sg), n), b = __fdiv_rn(warp_sum(sgx), n);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = __fmul_rn(r, __fsub_rn(__fsub_rn(g[i][j], a), __fmul_rn(xh[i][j], b)));
        }
        store8(dx + row * E + c * 8, o);
      }
    }
  }
  // The block's column sums, its warps added in warp order.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = lane + 32 * i;
        if (c < nc) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = c * 8 + j;
            red[0][e] = w == 0 ? ds[i][j] : red[0][e] + ds[i][j];
            red[1][e] = w == 0 ? db[i][j] : red[1][e] + db[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t P = gridDim.x;
  for (int e = threadIdx.x; e < E; e += kBlock) {
    partial[blockIdx.x * static_cast<size_t>(E) + e] = red[0][e];
    partial[(P + blockIdx.x) * static_cast<size_t>(E) + e] = red[1][e];
  }
}

__global__ void __launch_bounds__(kftpu_colsum::kFinishCols * kftpu_colsum::kFinishLanes)
    ln_dw(const float* __restrict__ partial, int P, int E, float* __restrict__ dscale,
          float* __restrict__ dbias) {
  float tot[2];
  const int c = kftpu_colsum::finish_sums<2>(partial, P, E, tot);
  if (c < 0) return;
  dscale[c] = tot[0];
  dbias[c] = tot[1];
}

// The smallest chunk count a lane holds for width E, 0 if too wide.
int chunks_for(int E) {
  const int nc = E / 8;
  if (nc <= 32) return 1;
  if (nc <= 64) return 2;
  if (nc <= 128) return 4;
  return 0;
}

bool valid(int dtype, long long rows, int E) {
  return (dtype == kF32 || dtype == kBF16) && rows > 0 && E > 0 && E % 8 == 0 &&
         chunks_for(E) > 0;
}

template <typename T>
cudaError_t fwd(const void* x, const float* scale, const float* bias, void* y, float* mean,
                float* rstd, long long rows, int E, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  auto args = [&](auto kernel) {
    kernel<<<grid, kBlock, 0, st>>>(static_cast<const T*>(x), scale, bias, static_cast<T*>(y),
                                    mean, rstd, rows, E);
  };
  switch (chunks_for(E)) {
    case 1: args(ln_fwd<T, 1>); break;
    case 2: args(ln_fwd<T, 2>); break;
    default: args(ln_fwd<T, 4>); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const float* scale, const void* dy, const float* mean,
                const float* rstd, void* dx, float* dscale, float* dbias, float* partial,
                long long rows, int E, int blocks, cudaStream_t st) {
  const long long per = (rows + blocks - 1) / blocks;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kBlock, 0, st>>>(static_cast<const T*>(x), scale, static_cast<const T*>(dy),
                                      mean, rstd, static_cast<T*>(dx), partial, rows, E, per);
  };
  switch (chunks_for(E)) {
    case 1: args(ln_bwd<T, 1>); break;
    case 2: args(ln_bwd<T, 2>); break;
    default: args(ln_bwd<T, 4>); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_dw<<<kftpu_colsum::finish_grid(E), kftpu_colsum::finish_block(), 0, st>>>(
      partial, blocks, E, dscale, dbias);
  return cudaGetLastError();
}

}  // namespace

// y = layer_norm(x) [rows, E] (x's dtype), mean and rstd [rows] f32; x, y
// contiguous and 16-byte aligned, E a multiple of 8 up to 1024; scale and
// bias f32 [E]. dtype 0 = f32, 1 = bf16. Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int kftpu_layer_norm_fwd(int dtype, const void* x, const void* scale,
                                    const void* bias, void* y, void* mean, void* rstd,
                                    long long rows, int E, void* stream) {
  if (!valid(dtype, rows, E)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *sc = static_cast<const float*>(scale), *bi = static_cast<const float*>(bias);
  float *m = static_cast<float*>(mean), *r = static_cast<float*>(rstd);
  return dtype == kBF16 ? fwd<__nv_bfloat16>(x, sc, bi, y, m, r, rows, E, st)
                        : fwd<float>(x, sc, bi, y, m, r, rows, E, st);
}

// dx [rows, E] (x's dtype), dscale and dbias [E] f32 from x, scale, dy and
// the forward's mean and rstd. ``partial``: [2, blocks, E] f32 scratch,
// ``blocks`` the row runs (1 .. rows). Returns the CUDA error code.
extern "C" int kftpu_layer_norm_bwd(int dtype, const void* x, const void* scale, const void* dy,
                                    const void* mean, const void* rstd, void* dx, void* dscale,
                                    void* dbias, void* partial, long long rows, int E,
                                    int blocks, void* stream) {
  if (!valid(dtype, rows, E) || blocks < 1 || blocks > rows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *sc = static_cast<const float*>(scale), *m = static_cast<const float*>(mean),
              *r = static_cast<const float*>(rstd);
  float *ds = static_cast<float*>(dscale), *db = static_cast<float*>(dbias),
        *pa = static_cast<float*>(partial);
  return dtype == kBF16
             ? bwd<__nv_bfloat16>(x, sc, dy, m, r, dx, ds, db, pa, rows, E, blocks, st)
             : bwd<float>(x, sc, dy, m, r, dx, ds, db, pa, rows, E, blocks, st);
}
