// SwiGLU forward and backward for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes); see kubeflow_tpu_torch/ops/swiglu.py.
//
// Replaces the XLA fusion of kubeflow_tpu/models/llama.py::Mlp (:657),
// ``h = nn.silu(gate) * up``, which jax.jit makes of the sigmoid, the two
// multiplies and their casts (and of their transposes in the backward).
// There is no Pallas kernel behind it.
//
// Function, per element, with g = gate, u = up (bf16 or f32) computed in
// f32, each operation one rounded f32 operation (no fused multiply-add)
// in the plain version's order, and each result rounded to the dtype where
// the plain version's tensor op rounds (rnd):
//   forward   den = 1 + exp(-g), a = rnd(g / den), h = rnd(a u);
//   backward  s = 1 / den, du = rnd(dh a), t = rnd(dh u),
//             dg = rnd((t s) (1 + g (1 - s)))
// so kernel and plain version agree bitwise. gate and up are rows of
// width F with their own row strides: two tensors, or the two halves of
// one fused [rows, 2, F] product (row stride 2F) read in place; the
// backward writes dg and du with their own row strides, so the fused
// product's gradient is one [rows, 2, F] tensor written whole.
//
// Bound on this card: bytes. The forward reads g and u and writes h (6
// bytes an element in bf16), the backward reads g, u and dh and writes dg
// and du (10): at the training shape [24564, 5632] 830 MB and 1.38 GB,
// 0.248 and 0.413 ms at 3.35 TB/s.
//
// Design: one thread per 8 consecutive elements of a row (16-byte loads
// and stores in bf16), consecutive threads along the row; no shared
// memory.

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_fwd(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ h,
               long long gs, long long us, int F, long long items) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= items) return;
  const int per_row = F / 8;
  const long long row = t / per_row;
  const int col = static_cast<int>(t % per_row) * 8;
  float gv[8], uv[8], o[8];
  load8(g + row * gs + col, gv);
  load8(u + row * us + col, uv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float den = __fadd_rn(1.f, expf(-gv[j]));
    const float a = rnd<T>(__fdiv_rn(gv[j], den));
    o[j] = __fmul_rn(a, uv[j]);
  }
  store8(h + row * static_cast<long long>(F) + col, o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_bwd(const T* __restrict__ g, const T* __restrict__ u, const T* __restrict__ dh,
               T* __restrict__ dg, T* __restrict__ du, long long gs, long long us,
               long long dgs, long long dus, int F, long long items) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= items) return;
  const int per_row = F / 8;
  const long long row = t / per_row;
  const int col = static_cast<int>(t % per_row) * 8;
  float gv[8], uv[8], dv[8], og[8], ou[8];
  load8(g + row * gs + col, gv);
  load8(u + row * us + col, uv);
  load8(dh + row * static_cast<long long>(F) + col, dv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float den = __fadd_rn(1.f, expf(-gv[j]));
    const float a = rnd<T>(__fdiv_rn(gv[j], den));
    const float s = __frcp_rn(den);
    ou[j] = __fmul_rn(dv[j], a);
    const float tt = rnd<T>(__fmul_rn(dv[j], uv[j]));
    const float slope = __fadd_rn(1.f, __fmul_rn(gv[j], __fsub_rn(1.f, s)));
    og[j] = __fmul_rn(__fmul_rn(tt, s), slope);
  }
  store8(dg + row * dgs + col, og);
  store8(du + row * dus + col, ou);
}

long long blocks_for(long long items) { return (items + kThreads - 1) / kThreads; }

bool valid(int dtype, long long rows, int F, long long items) {
  return (dtype == kF32 || dtype == kBF16) && rows > 0 && F > 0 && F % 8 == 0 &&
         blocks_for(items) < (1LL << 31);
}

}  // namespace

// h [rows, F] (contiguous) = silu(g) u, g and u rows of width F at row
// strides gs and us (elements; 8-element multiples, 16-byte aligned
// rows). dtype 0 = f32, 1 = bf16 for all three. Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int kftpu_swiglu_fwd(int dtype, const void* g, const void* u, void* h, long long rows,
                                int F, long long gs, long long us, void* stream) {
  const long long items = rows * (F / 8);
  if (!valid(dtype, rows, F, items)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(blocks_for(items));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    swiglu_fwd<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(h), gs, us, F, items);
  } else {
    swiglu_fwd<float><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(g),
                                                   static_cast<const float*>(u),
                                                   static_cast<float*>(h), gs, us, F, items);
  }
  return cudaGetLastError();
}

// dg and du (row strides dgs, dus) of h = silu(g) u from dh [rows, F]
// (contiguous). Returns the CUDA error code of the launch.
extern "C" int kftpu_swiglu_bwd(int dtype, const void* g, const void* u, const void* dh, void* dg,
                                void* du, long long rows, int F, long long gs, long long us,
                                long long dgs, long long dus, void* stream) {
  const long long items = rows * (F / 8);
  if (!valid(dtype, rows, F, items)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(blocks_for(items));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using B = __nv_bfloat16;
    swiglu_bwd<B><<<blocks, kThreads, 0, st>>>(
        static_cast<const B*>(g), static_cast<const B*>(u), static_cast<const B*>(dh),
        static_cast<B*>(dg), static_cast<B*>(du), gs, us, dgs, dus, F, items);
  } else {
    swiglu_bwd<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(u),
        static_cast<const float*>(dh), static_cast<float*>(dg), static_cast<float*>(du), gs,
        us, dgs, dus, F, items);
  }
  return cudaGetLastError();
}
