// The int8 expert product (K15) for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes); see kubeflow_tpu_torch/ops/int8_experts.py.
//
// Replaces the XLA fusion of the JAX engine's int8 weights into a Mixtral
// layer's expert einsums: kubeflow_tpu/serving/engine.py::_materialize
// (:1362-1372) dequantizes every int8 leaf inside the jitted steps, and XLA
// fuses the convert and the scale into the einsums of
// kubeflow_tpu/models/mixtral.py::MoeMlp.expert_fn (:94-115), so the
// device reads stay int8. There is no Pallas kernel behind it.
//
// Function: y[e, r, n] = sum_k x[e, r, k] W[e, n, k] with W[e, n, k] =
// bf16(q[e, n, k] * s[n, k]): x bf16 [E, R, K], q int8 [E, N, K], s bf16
// [N, K], y bf16 [E, R, N], all contiguous. The JAX engine quantizes an
// expert leaf [E, K, N] over its expert axis, so every weight element has
// its own scale, shared by the E experts; the port stores q and s with K
// contiguous ([E, N, K] and [1, N, K]), the layout K4 reads. Each weight is
// rounded to bf16 once, where _materialize rounds it; the bf16 x bf16
// products are exact in f32 and summed in f32; y is rounded once, as
// preferred_element_type=f32 then .astype does. N and K are multiples of
// 16; any E, R >= 1.
//
// Bound on this card: max(bytes / 3.35 TB/s, 2 E R N K / 989 TFLOP/s), bytes
// = E N K + 2 N K + 2 E R K + 2 E R N. Mixtral-8x7b's decode step (E = 8, R
// = 4): 587.2 MB a product (469.8 MB int8, 117.4 MB scale), 0.175 ms; a
// 4096-token prefill group (R = 1280): 1.20 TFLOP, 1.216 ms.
//
// The weights are the A operand of mma.sync m16n8k16 (16 output rows x 16
// k), x^T the B operand (16 k x 8 tokens); each weight is widened exactly
// from int8 to bf16 by byte permutes and multiplied by its scale with one
// rounding (fma.rn.bf16x2 with -0), as K4 (int8_linear.cu) does. Weights,
// scales and x arrive by 16-byte cp.async copies into a ring of stages
// shared by the block's warps, zero-filled past N, R and K.
//
// - Decode rows (R <= 16: one 8- or 16-token tile), int8_experts_decode.
//   The scale is as large as two int8 weights and shared by the experts,
//   so one block holds 32 weight rows for a group of 8 experts, a warp an
//   expert, over all of K: a scale byte leaves device memory once and
//   reaches the SM once, and a step reads 1.25 bytes a weight. (A block an
//   (expert, tile) would read each scale tile 8 times from L2: 3 bytes a
//   weight into the SMs.) As in K4's decode kernel, a lane's k slots are
//   permuted alike in A and B so that it reads 16 consecutive int8 of each
//   of its two weight rows, their 16 scales and 16 bf16 of its token row
//   with 16-byte loads. Stages of two spans of 64 k (128 contiguous bytes
//   of each int8 row), three in the ring (168 KB, a block a SM): gate/up
//   (N = 14336) is 448 blocks, down (N = 4096) 128, about one a SM, so K
//   is not split. (Blocks of 16 rows, or two blocks a SM, were slower.)
// - More rows (prefill groups, extend chunks), int8_experts_tiled: a block
//   a (expert, 128 weight rows, 128 or 256 tokens), 8 warps of 64 rows.
//   The block's threads dequantize each span once into shared memory, in
//   place of its scales (each weight once a block; warps that dequantized
//   their own fragments, as the decode kernel does, were about three
//   times slower), then the warps read A and B with ldmatrix; span j + 1
//   is dequantized between span j's k-steps, one barrier a span. The
//   cp.async copies into the SMs, not the products, appear to bound both
//   kernels (PERF.md); TMA and wgmma (K4's prefill design) are later work.
// Capture-safe: nothing is allocated, nothing synchronises, the launch goes
// on the caller's stream. Deterministic: no atomics, a fixed order of sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "int8_common.cuh"

namespace {

using hopper::smem_u32;
using namespace int8w;

constexpr int kSpan = 64;   // k a span

struct Params {
  const __nv_bfloat16* x;      // [E, R, K]
  const int8_t* q;             // [E, N, K]
  const __nv_bfloat16* scale;  // [N, K]
  __nv_bfloat16* y;            // [E, R, N]
  int E, R, N, K;
};

// ---- decode rows: a warp an expert ----------------------------------------------

// A block of G = 8 warps, one an expert of its group, each over the block's
// BN = 16 NT weight rows and BM = 8 MT tokens. The warps share one ring of
// STAGES stages of SUB consecutive spans; a span holds the BN scale rows
// once, then each expert's BN int8 rows and BM x rows.
constexpr int G = 8;

template <int NT, int MT, int STAGES, int SUB>
struct Decode {
  static constexpr int kThreads = 32 * G;
  static constexpr int BN = 16 * NT;
  static constexpr int BM = 8 * MT;
  static constexpr int kSBytes = BN * kSpan * 2;    // bf16 scale rows of 128 bytes
  static constexpr int kQBytes = BN * kSpan;        // an expert's int8 rows of 64 bytes
  static constexpr int kXBytes = BM * kSpan * 2;    // an expert's bf16 x rows of 128 bytes
  static constexpr int kSub = kSBytes + G * (kQBytes + kXBytes);
  static constexpr int kStage = SUB * kSub;
  static constexpr int kSmem = STAGES * kStage;
};

template <int NT, int MT, int STAGES, int SUB>
__global__ void __launch_bounds__(32 * G) int8_experts_decode(const Params p) {
  using Sh = Decode<NT, MT, STAGES, SUB>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * Sh::BM, n0 = blockIdx.y * Sh::BN, e0 = blockIdx.z * G;
  const int e = e0 + g;   // this warp's expert
  const int stages = (p.K + SUB * kSpan - 1) / (SUB * kSpan);

  // Stage j: SUB spans of 64 k from k = j SUB 64. Consecutive threads copy
  // consecutive 16-byte chunks of a row.
  auto load = [&](int j) {
    uint8_t* st = smem + (j % STAGES) * Sh::kStage;
    const int k0 = j * SUB * kSpan;
    for (int c = threadIdx.x; c < Sh::BN * 8 * SUB; c += Sh::kThreads) {
      const int row = c / (8 * SUB), ch = c % (8 * SUB), k = k0 + ch * 8, n = n0 + row;
      const bool ok = n < p.N && k < p.K;
      cp_async_16(st + (ch >> 3) * Sh::kSub + row * 128 + (x_pos(ch & 7, row) << 4),
                  ok ? p.scale + (long long)n * p.K + k : p.scale, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < G * Sh::BN * 4 * SUB; c += Sh::kThreads) {
      const int ge = c / (Sh::BN * 4 * SUB), rc = c % (Sh::BN * 4 * SUB);
      const int row = rc / (4 * SUB), ch = rc % (4 * SUB), k = k0 + ch * 16, n = n0 + row;
      const bool ok = e0 + ge < p.E && n < p.N && k < p.K;
      cp_async_16(st + (ch >> 2) * Sh::kSub + Sh::kSBytes + ge * Sh::kQBytes + row * kSpan +
                      (ch & 3) * 16,
                  ok ? p.q + ((long long)(e0 + ge) * p.N + n) * p.K + k : p.q, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < G * Sh::BM * 8 * SUB; c += Sh::kThreads) {
      const int ge = c / (Sh::BM * 8 * SUB), rc = c % (Sh::BM * 8 * SUB);
      const int row = rc / (8 * SUB), ch = rc % (8 * SUB), k = k0 + ch * 8, m = m0 + row;
      const bool ok = e0 + ge < p.E && m < p.R && k < p.K;
      cp_async_16(st + (ch >> 3) * Sh::kSub + Sh::kSBytes + G * Sh::kQBytes + ge * Sh::kXBytes +
                      row * 128 + (x_pos(ch & 7, row) << 4),
                  ok ? p.x + ((long long)(e0 + ge) * p.R + m) * p.K + k : p.x, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < stages) load(j);
    cp_async_commit();
  }

  float acc[NT][MT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.f;

  for (int j = 0; j < stages; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // stage j landed for all; stage j - 1's slot is free
    if (j + STAGES - 1 < stages) load(j + STAGES - 1);
    cp_async_commit();
    if (e >= p.E) continue;      // a warp of a missing expert (E not a multiple of G)

#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const uint32_t ss = smem_u32(smem + (j % STAGES) * Sh::kStage + sub * Sh::kSub);
      const uint32_t qs = ss + Sh::kSBytes + g * Sh::kQBytes;
      const uint32_t xs = ss + Sh::kSBytes + G * Sh::kQBytes + g * Sh::kXBytes;
      // B fragments of the span's four k-steps: words 2i, 2i + 1 of a token row.
      uint32_t b[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 8 + lr;
        const uint4 lo = lds128(xs + r * 128 + (x_pos(2 * t, r) << 4));
        const uint4 hi = lds128(xs + r * 128 + (x_pos(2 * t + 1, r) << 4));
        b[mt][0] = lo.x; b[mt][1] = lo.y; b[mt][2] = lo.z; b[mt][3] = lo.w;
        b[mt][4] = hi.x; b[mt][5] = hi.y; b[mt][6] = hi.z; b[mt][7] = hi.w;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t a[4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = nt * 16 + lr + 8 * h;
          const uint4 w = lds128(qs + r * kSpan + t * 16);
          // The scales of k 16t .. 16t + 15: chunks 2t, 2t + 1 of row r.
          const uint4 s0 = lds128(ss + r * 128 + (x_pos(2 * t, r) << 4));
          const uint4 s1 = lds128(ss + r * 128 + (x_pos(2 * t + 1, r) << 4));
          const uint32_t sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          uint32_t d[8];
          dequant16(w, sc, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i][h] = d[2 * i];
            a[i][2 + h] = d[2 * i + 1];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_16816(acc[nt][mt], a[i], b[mt][2 * i], b[mt][2 * i + 1]);
      }
    }
  }
  if (e >= p.E) return;

  // A lane holds rows lr, lr + 8 of each 16-row tile, tokens 2t, 2t + 1 of
  // each 8-token tile: acc[nt][mt][2 h + c] is (row lr + 8 h, token 2t + c).
  __nv_bfloat16* y = p.y + (long long)e * p.R * p.N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + nt * 16 + lr + 8 * (i >> 1);
        const int m = m0 + mt * 8 + 2 * t + (i & 1);
        if (n < p.N && m < p.R) y[(long long)m * p.N + n] = __float2bfloat16_rn(acc[nt][mt][i]);
      }
}

// ---- more rows: the dequantized tile in shared memory -------------------------

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; d[i] is matrix i's fragment (a lane holds row
// lane / 4, columns 2 (lane % 4), + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// The byte offset of 16-byte chunk c of row r in a tile of 128-byte rows,
// swizzled (c ^ r % 8) so that ldmatrix's 8 rows of one chunk hit
// distinct banks.
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A block a (expert, BN = 128 weight rows, BM tokens), 8 warps of 64 rows x
// BM / 4 tokens (NT = 4 16-row tiles x MT 8-token tiles). Each stage brings
// one 64-k span of the int8 rows, their scales and the x rows by cp.async.
// The block's threads dequantize a span once, in place: each 16-byte chunk
// of 8 scales becomes the chunk of its 8 weights, bf16(q s) (each weight
// once a block, where the decode kernel's warps would do it once a warp).
// The warps then take A from that tile and B from the x tile with ldmatrix
// and multiply with mma.sync; span j + 1 is dequantized between span j's
// k-steps, so its ALU work overlaps the products and one barrier a span
// suffices.
template <int MT, int STAGES>
struct Tiled {
  static constexpr int kThreads = 256;
  static constexpr int BN = 128, NT = 4;
  static constexpr int BM = 32 * MT;
  static constexpr int kQBytes = BN * kSpan;          // int8 rows of 64 bytes
  static constexpr int kSBytes = BN * kSpan * 2;      // bf16 scale, then weight, rows of 128 bytes
  static constexpr int kXBytes = BM * kSpan * 2;      // bf16 x rows of 128 bytes
  static constexpr int kStage = kQBytes + kSBytes + kXBytes;
  static constexpr int kSmem = STAGES * kStage;
};

template <int MT, int STAGES>
__global__ void __launch_bounds__(256) int8_experts_tiled(const Params p) {
  using T = Tiled<MT, STAGES>;
  static_assert(STAGES >= 3, "span j + 1 is dequantized while j is multiplied");
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp & 1, wm = warp >> 1;            // 2 x 4 warps
  const int lr = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN, e = blockIdx.z;
  const int8_t* q = p.q + (long long)e * p.N * p.K;
  const __nv_bfloat16* x = p.x + (long long)e * p.R * p.K;
  const int stages = (p.K + kSpan - 1) / kSpan;

  auto load = [&](int j) {
    uint8_t* st = smem + (j % STAGES) * T::kStage;
    const int k0 = j * kSpan;
    for (int c = threadIdx.x; c < T::BN * 4; c += T::kThreads) {
      const int row = c >> 2, ch = c & 3, k = k0 + ch * 16, n = n0 + row;
      const bool ok = n < p.N && k < p.K;
      cp_async_16(st + row * kSpan + ch * 16, ok ? q + (long long)n * p.K + k : p.q, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < T::BN * 8; c += T::kThreads) {
      const int row = c >> 3, ch = c & 7, k = k0 + ch * 8, n = n0 + row;
      const bool ok = n < p.N && k < p.K;
      cp_async_16(st + T::kQBytes + sw128(row, ch),
                  ok ? p.scale + (long long)n * p.K + k : p.scale, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < T::BM * 8; c += T::kThreads) {
      const int row = c >> 3, ch = c & 7, k = k0 + ch * 8, m = m0 + row;
      const bool ok = m < p.R && k < p.K;
      cp_async_16(st + T::kQBytes + T::kSBytes + sw128(row, ch),
                  ok ? x + (long long)m * p.K + k : p.x, ok ? 16 : 0);
    }
  };
  // Chunk i (of 4) of this thread in span j's tile: its 8 int8 weights and
  // 8 scales become 8 bf16 weights, bf16(q s), written over the scales (a
  // thread reads and writes only its own chunks).
  auto dequant = [&](int j, int i) {
    const uint32_t st = smem_u32(smem + (j % STAGES) * T::kStage);
    const int c = threadIdx.x + i * T::kThreads, row = c >> 3, ch = c & 7;
    uint32_t w0, w1;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w0), "=r"(w1)
                 : "r"(st + row * kSpan + ch * 8)
                 : "memory");
    const uint32_t at = st + T::kQBytes + sw128(row, ch);
    const uint4 sc = lds128(at);
    const uint32_t f0 = w0 ^ 0x80808080u, f1 = w1 ^ 0x80808080u;
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                 "r"(bf16x2_mul(int8_pair<0, 1>(f0), sc.x)),
                 "r"(bf16x2_mul(int8_pair<2, 3>(f0), sc.y)),
                 "r"(bf16x2_mul(int8_pair<0, 1>(f1), sc.z)),
                 "r"(bf16x2_mul(int8_pair<2, 3>(f1), sc.w))
                 : "memory");
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < stages) load(j);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();                // span 0 landed
#pragma unroll
  for (int i = 0; i < 4; ++i) dequant(0, i);

  float acc[T::NT][MT][4];
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.f;

  for (int j = 0; j < stages; ++j) {
    cp_async_wait<STAGES - 3>();
    // Span j + 1 landed and span j dequantized for all; span j - 1's slot
    // is free.
    __syncthreads();
    if (j + STAGES - 1 < stages) load(j + STAGES - 1);
    cp_async_commit();
    const uint32_t st = smem_u32(smem + (j % STAGES) * T::kStage);
    const uint32_t ws = st + T::kQBytes, xs = ws + T::kSBytes;
    // A's and B's fragments of k-step kk (16 k): A [nt] from the weight
    // tile; B [mp] the tokens of two 8-token tiles, matrices (tile 0, k
    // 0-7), (tile 0, k 8-15), (tile 1, k 0-7), (tile 1, k 8-15).
    uint32_t a[2][T::NT][4], b[2][MT / 2][4];
    auto fragments = [&](int kk, uint32_t (&fa)[T::NT][4], uint32_t (&fb)[MT / 2][4]) {
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int r = wn * 64 + nt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(fa[nt], ws + sw128(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int mp = 0; mp < MT / 2; ++mp) {
        const int r = wm * (8 * MT) + mp * 16 + (lane & 7) + 8 * (lane >> 4);
        ldmatrix_x4(fb[mp], xs + sw128(r, 2 * kk + ((lane >> 3) & 1)));
      }
    };
    fragments(0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 k a step; the next step's fragments load first
      const int cur = kk & 1;
      if (kk < 3) fragments(kk + 1, a[cur ^ 1], b[cur ^ 1]);
#pragma unroll
      for (int mp = 0; mp < MT / 2; ++mp)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          mma_16816(acc[nt][2 * mp], a[cur][nt], b[cur][mp][0], b[cur][mp][1]);
          mma_16816(acc[nt][2 * mp + 1], a[cur][nt], b[cur][mp][2], b[cur][mp][3]);
        }
      if (j + 1 < stages) dequant(j + 1, kk);
    }
  }

  __nv_bfloat16* y = p.y + (long long)e * p.R * p.N;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + wn * 64 + nt * 16 + lr + 8 * (i >> 1);
        const int m = m0 + wm * (8 * MT) + mt * 8 + 2 * t + (i & 1);
        if (n < p.N && m < p.R) y[(long long)m * p.N + n] = __float2bfloat16_rn(acc[nt][mt][i]);
      }
}

// The launches: grid (token tiles, row tiles, experts or expert groups),
// tokens the fastest axis.
template <int NT, int MT, int STAGES, int SUB>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  using Sh = Decode<NT, MT, STAGES, SUB>;
  constexpr auto fn = &int8_experts_decode<NT, MT, STAGES, SUB>;
  static bool opted = false;
  cudaError_t err = flash::allow_smem(fn, Sh::kSmem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + Sh::BM - 1) / Sh::BM, (p.N + Sh::BN - 1) / Sh::BN, (p.E + G - 1) / G);
  fn<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int MT, int STAGES>
cudaError_t launch_tiled(const Params& p, cudaStream_t stream) {
  using T = Tiled<MT, STAGES>;
  constexpr auto fn = &int8_experts_tiled<MT, STAGES>;
  static bool opted = false;
  cudaError_t err = flash::allow_smem(fn, T::kSmem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + T::BM - 1) / T::BM, (p.N + T::BN - 1) / T::BN, p.E);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// y[e] = x[e] . dequant(q[e], scale)^T for every expert e (see the header):
// x bf16 [E, R, K], q int8 [E, N, K], scale bf16 [N, K], y bf16 [E, R, N],
// all contiguous and 16-byte aligned; N and K multiples of 16, E and R >= 1.
// Decode rows (R <= 8 or <= 16) take the expert-group kernel, more rows the
// tiled one. Returns the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_int8_experts(const void* x, const void* q, const void* scale, void* y, int E,
                                  int R, int N, int K, void* stream) {
  if (E < 1 || R < 1 || N < 16 || N % 16 || K < 16 || K % 16) return cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                 static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(y),
                 E, R, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 8) return static_cast<int>(launch_decode<2, 1, 3, 2>(p, st));
  if (R <= 16) return static_cast<int>(launch_decode<2, 2, 3, 2>(p, st));
  if (R <= 128) return static_cast<int>(launch_tiled<4, 4>(p, st));
  return static_cast<int>(launch_tiled<8, 3>(p, st));
}
