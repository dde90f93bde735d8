// Helpers of the fused element-wise kernels (rms_norm.cu, rope.cu,
// cross_entropy.cu, optimizer.cu): eight consecutive elements moved between
// device memory and f32 registers with 16-byte accesses, and a block sum
// whose order depends only on the block size (so two calls are bitwise
// equal).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kftpu_fused {

// dtype codes shared with the Python wrappers.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// bf16 <-> f32 by their bits (a bf16 is the top half of an f32), rounding
// to nearest even as PyTorch's bf16 conversion does (a NaN stays a quiet
// NaN). No local is addressed, so nothing goes to the stack; the
// intrinsics' addressed temporaries made ptxas spill inside a loop.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// Eight consecutive elements at p (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack2(raw.x, v[0], v[1]);
  unpack2(raw.y, v[2], v[3]);
  unpack2(raw.z, v[4], v[5]);
  unpack2(raw.w, v[6], v[7]);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight f32 values rounded once (to nearest even) into p.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bf16_bits(v));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// f32 rounded to the storage type and back: what a tensor of that dtype
// holds after an op writes v.
__device__ __forceinline__ float round_to(float v, int dtype) {
  return dtype == kBF16 ? __uint_as_float(bf16_bits(v) << 16) : v;
}

// round_to for a storage type known at compile time.
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return round_to(v, kBF16); }

// The sum of v over the block's kThreads threads, returned to every thread.
// A butterfly within each warp, then every warp sums the warps' totals in
// warp order: a fixed order for a fixed block size. ``red`` holds
// kThreads / 32 floats; the leading barrier lets a caller reuse it.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  float t = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

}  // namespace kftpu_fused
