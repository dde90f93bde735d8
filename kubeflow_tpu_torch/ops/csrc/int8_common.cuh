// Pieces shared by the int8-weight products: K4 (int8_linear.cu) and K15
// (int8_experts.cu). cp.async copies into shared memory, 4- and 16-byte
// shared loads, the wgmma of a register A tile at 64, 128 or 256 tokens,
// the mma.sync bf16 product, the exact int8 -> bf16 widening and
// the once-rounded bf16 product with a scale (_materialize's bf16(q s)),
// the swizzle of a lane's two 16-byte chunks of a 128-byte row, and
// SwiGLU of a gate and an up sum (both kernels' epilogue).
// ops/_build.py hashes this header into every kernel library's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "fused_common.cuh"
#include "hopper_common.cuh"

namespace int8w {

using hopper::smem_u32;

// 16 bytes global -> shared; only the first ``bytes`` (16 or 0) are read,
// the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The first 1024-byte boundary at or after ``p`` in shared memory (where
// 128-byte-swizzled TMA tiles start).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// d[BM / 2] += A (64 x 16, bf16 registers) * B (16 x BM, bf16 in shared
// memory, K-major: db): the wgmma of a 64-row A tile and BM = 64, 128 or
// 256 tokens.
template <int BM>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[BM / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (BM == 256) {
    hopper::wgmma_rs_m64n256k16(d, a, db);
  } else if constexpr (BM == 128) {
    hopper::wgmma_rs_m64n128k16(d, a, db);
  } else {
    hopper::wgmma_rs_m64n64k16(d, a, db, 1);
  }
}

// d[4] += A (16 x 16 bf16) * B (16 x 8 bf16), f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 of two int8 bytes (lo, hi) of a word whose bytes were flipped to
// x + 128: each lands in the low mantissa byte of 1.5 * 2^23, and the float
// minus (1.5 * 2^23 + 128) is x exactly (exact in bf16 too).
template <int LO, int HI>
__device__ __forceinline__ uint32_t int8_pair(uint32_t flipped) {
  const float lo = __uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7640u | LO)) - 12583040.f;
  const float hi = __uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7640u | HI)) - 12583040.f;
  return flash::pack_bf16(lo, hi);
}

// a * b on bf16 pairs, rounded once to nearest even: the fma adds -0, which
// leaves every product (signed zeros included) as it is.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// The four words of 16 int8 weights (k order), dequantized with the
// scales sc[2 i], sc[2 i + 1] of their pairs: eight bf16x2 words in k order.
__device__ __forceinline__ void dequant16(const uint4& w, const uint32_t (&sc)[8],
                                          uint32_t (&out)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t f = words[i] ^ 0x80808080u;
    out[2 * i] = bf16x2_mul(int8_pair<0, 1>(f), sc[2 * i]);
    out[2 * i + 1] = bf16x2_mul(int8_pair<2, 3>(f), sc[2 * i + 1]);
  }
}

// The 16-byte position of chunk c (8 bf16) of row r in its 128-byte ring
// row (x rows, and K15's scale rows): a lane reads chunks 2t and 2t + 1 of its row, so the chunks are
// stored even ones first, and odd rows swap the halves; the 8 lanes of a
// quarter warp (rows r, r + 1; t = 0..3) then hit distinct banks.
__device__ __forceinline__ int x_pos(int c, int r) {
  return (((c & 1) << 2) | (c >> 1)) ^ ((r & 1) << 2);
}

// silu(g) * u of a product's unrounded sums g and u, as the product then K9
// compute it: g and u rounded to bf16 (the product's outputs), then
// swiglu.cu's forward operation by operation, rounded once more where it
// rounds. K4's and K15's SwiGLU epilogues.
__device__ __forceinline__ uint16_t swiglu_of_sums(float g, float u) {
  const float gb = __bfloat162float(__float2bfloat16_rn(g));
  const float ub = __bfloat162float(__float2bfloat16_rn(u));
  const float den = __fadd_rn(1.f, expf(-gb));
  const float a = kftpu_fused::rnd<__nv_bfloat16>(__fdiv_rn(gb, den));
  return static_cast<uint16_t>(kftpu_fused::bf16_bits(__fmul_rn(a, ub)));
}

}  // namespace int8w
