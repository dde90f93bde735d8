// Pieces shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: constants of the masking and
// exp2 domains, the f32 kernels' block shape, the bf16 pair packing and the
// dynamic shared-memory opt-in.
// ops/_build.py hashes this header into every kernel library's name, so an
// edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;   // finite: fully masked rows stay NaN-free
constexpr float kMClamp = -1e29f;   // exp2(s - max(m, kMClamp)) -> 0 when m == kNegInf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Two floats -> packed bf16x2; ``lo`` lands in the low half (the smaller
// column index of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Opts a kernel in to ``bytes`` of dynamic shared memory (needed above
// 48 KB), once per kernel instantiation; racing first calls set the same
// value.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace flash
