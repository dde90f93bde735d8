// Pieces shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: constants of the masking and
// exp2 domains, the bf16 tensor-core product and the shared-tile loader.
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
constexpr int kPad = 8;             // bf16 row padding: breaks smem bank conflicts

// c += a * b on the tensor cores: a is a 16x16 bf16 A fragment, (b0, b1) a
// 16x8 bf16 B fragment, c a 16x8 f32 accumulator (mma.sync m16n8k16).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> packed bf16x2; ``lo`` lands in the low half (the smaller
// column index of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows r0 and r0 + 8, columns c0 .. c0 + 15 of a padded
// bf16 shared tile (r0 = warp row + lane / 4, c0 = k chunk + 2 * (lane % 4)).
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                            int r0, int c0) {
  constexpr int kLd = D + kPad;
  const __nv_bfloat16* p = tile + r0 * kLd + c0;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
}

// The B fragment (k x n = 16 x 8) whose n index runs over ROWS of a padded
// shared tile and whose k index runs along them: row n0 + lane / 4, columns
// k0 + 2 * (lane % 4) (+ 8). Q K^T takes K this way.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int row, int c0) {
  constexpr int kLd = D + kPad;
  const __nv_bfloat16* p = tile + row * kLd + c0;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The B fragment whose k index runs over ROWS of the tile (rows k0 + 2 *
// (lane % 4) and the next, + 8 and + 9) and whose n index is column d:
// P V takes V this way. Gathered as 16-bit scalars.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int k0, int d) {
  constexpr int kLd = D + kPad;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(tile);
  b0 = static_cast<uint32_t>(s[k0 * kLd + d]) |
       (static_cast<uint32_t>(s[(k0 + 1) * kLd + d]) << 16);
  b1 = static_cast<uint32_t>(s[(k0 + 8) * kLd + d]) |
       (static_cast<uint32_t>(s[(k0 + 9) * kLd + d]) << 16);
}

// Copies ``rows_valid`` rows of D bf16 (row stride ``row_stride`` elements)
// into a ROWS-row shared tile with 16-byte loads; rows past the edge are
// zero so the products over them stay finite.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                          long long row_stride, int rows_valid) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + kPad;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + cc * 8);
    }
    *reinterpret_cast<uint4*>(smem + r * kLd + cc * 8) = val;
  }
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
