// The language-model cross-entropy, forward and backward, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/train/losses.py.
//
// Replaces the XLA fusions of kubeflow_tpu/train/losses.py::
// cross_entropy_loss (:11) and softmax_accuracy (:120): jax.jit fuses the
// upcast, logsumexp, label gather, smoothing and z-loss terms and the
// argmax into reductions over the logits, and their transpose into one
// pass. There is no Pallas kernel behind them.
//
// Function, per row r of logits [N, V] (bf16 or f32) with label y_r and
// weight w_r (the mask; 1 without one), in f32:
//   logz = log sum_j exp(x_j);  nll = logz - x_y;
//   label smoothing ls > 0: nll = (1 - ls) nll + ls (logz - mean_j x_j);
//   z-loss zw > 0: nll += zw logz^2;  hit = (argmax_j x_j == y), the lowest
//   index on ties, as jnp.argmax.
// Forward: sums[0..2] = (sum_r w_r nll_r, sum_r w_r, sum_r w_r hit_r), and
// logz [N] f32, which the backward reads instead of recomputing it.
// Backward, with g the cotangent of sums[0] and p_j = exp(x_j - logz):
//   dlogits[r, j] = g w_r (p_j (1 + 2 zw logz) - ls / V - (1 - ls)[j == y]),
// rounded once to the logits' dtype.
//
// Bound on this card: bytes. The forward reads the logits once, the
// backward reads them once and writes dlogits once: at the training shape
// [24564, 32000] bf16, 1.57 GB and 3.14 GB, 0.47 and 0.94 ms.
//
// Design: one block of 256 threads a row, each thread walking the row's
// 16-byte chunks with a running max and a rescaled running sum of exp (an
// online logsumexp), the sum of x and the first index of its max; the block
// merges them in a fixed order. Rows write their terms to a [N, 3] buffer
// and a one-block kernel sums it in row order: no atomics, so two calls are
// bitwise equal. The backward writes each row in one pass.

#include <math.h>

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

struct Stat {
  float m, s;   // running max and sum of exp(x - m)
  float sx;     // sum of x
  float bv;     // max value and its first index
  int bi;
};

__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  const float m = fmaxf(a.m, b.m);
  const float sa = a.m == -INFINITY ? 0.f : a.s * __expf(a.m - m);
  const float sb = b.m == -INFINITY ? 0.f : b.s * __expf(b.m - m);
  a.m = m;
  a.s = sa + sb;
  a.sx += b.sx;
  if (b.bv > a.bv || (b.bv == a.bv && b.bi < a.bi)) {
    a.bv = b.bv;
    a.bi = b.bi;
  }
}

__device__ __forceinline__ Stat shfl(const Stat& a, int o) {
  Stat b;
  b.m = __shfl_xor_sync(0xffffffffu, a.m, o);
  b.s = __shfl_xor_sync(0xffffffffu, a.s, o);
  b.sx = __shfl_xor_sync(0xffffffffu, a.sx, o);
  b.bv = __shfl_xor_sync(0xffffffffu, a.bv, o);
  b.bi = __shfl_xor_sync(0xffffffffu, a.bi, o);
  return b;
}

// Fold eight consecutive values starting at column j0 into a thread's stat.
__device__ __forceinline__ void fold8(Stat& st, const float v[8], int j0) {
  float cm = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) cm = fmaxf(cm, v[j]);
  if (cm > st.m) {
    st.s = st.m == -INFINITY ? 0.f : st.s * __expf(st.m - cm);
    st.m = cm;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st.s += __expf(v[j] - st.m);
    st.sx += v[j];
    if (v[j] > st.bv) {
      st.bv = v[j];
      st.bi = j0 + j;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd(const T* __restrict__ logits, const long long* __restrict__ labels,
           const float* __restrict__ weights, float* __restrict__ logz_out,
           float* __restrict__ terms, int V, float zw, float ls) {
  __shared__ Stat red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = logits + row * V;
  const int nc = V / 8;
  Stat st{-INFINITY, 0.f, 0.f, -INFINITY, 0x7fffffff};
  int c = threadIdx.x;
  // Four chunks in flight a thread, then the tail.
  for (; c + 3 * kThreads < nc; c += 4 * kThreads) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) load8(xr + (c + u * kThreads) * 8, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) fold8(st, v[u], (c + u * kThreads) * 8);
  }
  for (; c < nc; c += kThreads) {
    float v[8];
    load8(xr + c * 8, v);
    fold8(st, v, c * 8);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge(st, shfl(st, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat t = red[0];
    for (int i = 1; i < kThreads / 32; ++i) merge(t, red[i]);
    const float logz = t.m + logf(t.s);
    long long y = labels[row];
    y = y < 0 ? 0 : (y >= V ? V - 1 : y);
    const float xy = load1(xr + y);
    float nll = logz - xy;
    if (ls > 0.f) {
      nll = (1.f - ls) * nll + ls * (logz - t.sx / static_cast<float>(V));
    }
    if (zw > 0.f) nll = nll + zw * (logz * logz);
    const float w = weights == nullptr ? 1.f : weights[row];
    logz_out[row] = logz;
    terms[row * 3 + 0] = nll * w;
    terms[row * 3 + 1] = w;
    terms[row * 3 + 2] = (t.bi == y ? 1.f : 0.f) * w;
  }
}

// sums[k] = sum over rows of terms[r, k], in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    ce_sum(const float* __restrict__ terms, float* __restrict__ sums, long long N) {
  __shared__ float red[kSumThreads / 32];
  float a[3] = {0.f, 0.f, 0.f};
  for (long long r = threadIdx.x; r < N; r += kSumThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] += terms[r * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = block_sum<kSumThreads>(a[k], red);
    if (threadIdx.x == 0) sums[k] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd(const T* __restrict__ logits, const long long* __restrict__ labels,
           const float* __restrict__ weights, const float* __restrict__ logz,
           const float* __restrict__ g, T* __restrict__ dlogits, int V, float zw, float ls) {
  const size_t row = blockIdx.x;
  const T* xr = logits + row * V;
  T* dr = dlogits + row * V;
  const float lz = logz[row];
  const float coef = g[0] * (weights == nullptr ? 1.f : weights[row]);
  const float a = 1.f + 2.f * zw * lz;
  const float off = ls / static_cast<float>(V);
  long long y = labels[row];
  y = y < 0 ? 0 : (y >= V ? V - 1 : y);
  const int nc = V / 8;
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    float v[8];
    load8(xr + c * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d = __expf(v[j] - lz) * a - off;
      if (c * 8 + j == y) d -= 1.f - ls;
      v[j] = coef * d;
    }
    store8(dr + c * 8, v);
  }
}

bool valid(int dtype, long long N, int V) {
  return (dtype == kF32 || dtype == kBF16) && N > 0 && N < (1LL << 31) && V > 0 && V % 8 == 0;
}

}  // namespace

// Forward over logits [N, V] (contiguous, 16-byte aligned; dtype 0 = f32,
// 1 = bf16), labels [N] int64, weights [N] f32 or null: logz [N] f32, the
// per-row terms [N, 3] f32 (scratch) and sums [3] f32. Labels outside
// [0, V) are clamped. Returns the CUDA error code of the launch.
extern "C" int kftpu_cross_entropy_fwd(int dtype, const void* logits, const void* labels,
                                       const void* weights, void* logz, void* terms, void* sums,
                                       long long N, int V, float zw, float ls, void* stream) {
  if (!valid(dtype, N, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const float* w = static_cast<const float*>(weights);
  float* lz = static_cast<float*>(logz);
  float* t = static_cast<float*>(terms);
  const unsigned grid = static_cast<unsigned>(N);
  if (dtype == kBF16) {
    ce_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), y, w, lz, t, V, zw, ls);
  } else {
    ce_fwd<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(logits), y, w, lz, t, V,
                                            zw, ls);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_sum<<<1, kSumThreads, 0, st>>>(t, static_cast<float*>(sums), N);
  return cudaGetLastError();
}

// dlogits [N, V] (the logits' dtype) from the logits, labels, weights (or
// null), the forward's logz and g [1] f32, the cotangent of sums[0].
extern "C" int kftpu_cross_entropy_bwd(int dtype, const void* logits, const void* labels,
                                       const void* weights, const void* logz, const void* g,
                                       void* dlogits, long long N, int V, float zw, float ls,
                                       void* stream) {
  if (!valid(dtype, N, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const float* w = static_cast<const float*>(weights);
  const float* lz = static_cast<const float*>(logz);
  const float* gg = static_cast<const float*>(g);
  const unsigned grid = static_cast<unsigned>(N);
  if (dtype == kBF16) {
    ce_bwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), y, w, lz, gg,
        static_cast<__nv_bfloat16*>(dlogits), V, zw, ls);
  } else {
    ce_bwd<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(logits), y, w, lz, gg,
                                            static_cast<float*>(dlogits), V, zw, ls);
  }
  return cudaGetLastError();
}
