// Products with int8 weights for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see kubeflow_tpu_torch/ops/int8_linear.py.
//
// Replaces the XLA fusion of the JAX engine's weight-only int8 serving:
// kubeflow_tpu/serving/engine.py::ServingEngine._materialize (:1362)
// dequantizes every int8 leaf inside the jitted prefill (:1398), extend
// (:1608) and decode (:1857) steps, and XLA fuses the convert and the scale
// into the dots that consume them. There is no Pallas kernel behind it.
//
// Function: y[M, N] = x[M, K] . W^T with W[n, k] = bf16(bf16(q[n, k]) *
// scale[n, k mod S]): x bf16 (row stride ldx), q int8 [N, K], scale bf16
// [N, S], y bf16. Each weight is rounded to bf16 once, where _materialize
// rounds it (the scale of o_proj varies along K, S = head_dim, so it cannot
// be taken out of the sum); the bf16 x bf16 products are exact in f32 and
// summed in f32; y is rounded once. N and K are multiples of 16, any M >= 1;
// S is 1 or a multiple of 16 up to 256 that divides K. No activation is
// quantized: the tensor cores multiply bf16 (W8A16), not int8.
//
// Bound on this card at the decode point, M = 8 (one row a slot): bytes.
// Each weight byte feeds 2 M = 16 flops; the bound is
// max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s) with bytes = N K + 2 N S +
// 2 M K + 2 M N: llama3-8b's q/o 5.0 / 5.3 us, k/v 1.25, gate/up/down 17.6,
// lm_head 157.5, 2.26 ms over the 225 products of a decode step.
//
// Design:
// - Weights are the A operand of mma.sync m16n8k16 (16 output rows x 16 k),
//   x^T the B operand (16 k x 8 tokens): x [M, K] row-major already is the
//   K x M column-major operand, and at M = 8 one n8 tile holds every token.
//   K is walked in 64-wide spans; inside a span a lane's k slots are
//   permuted (k-step i, slot pair 2t/2t+8 -> k 16t + 4i .. + 3), the same
//   for A and B, so a lane reads 16 consecutive int8 of each of its two
//   weight rows and 16 consecutive bf16 of its token row with 16-byte loads.
//   The int8 values are widened exactly to bf16 in registers by byte
//   permutes (as decode_attention.cu does for the int8 cache) and
//   multiplied by their bf16 scales with one rounding (fma.rn.bf16x2 with
//   -0), which is _materialize's bf16 product.
// - Weights and x arrive by 16-byte cp.async copies into a ring of stages
//   shared by the block's warps, zero-filled past N, M and K; per-column
//   scales (S > 1) are copied with the first stage, swizzled, per-row
//   scales (S = 1) sit in registers. At decode a stage holds two spans, so
//   it reads 128 contiguous bytes of each weight row (a whole L2 line; at
//   64 bytes the lm_head took 286 us against 204), and three stages are in
//   flight while one is computed.
// - Decode (M <= 16): a block's 8 warps own one 16-row tile each (128 rows
//   a block) and read the same x span, so x leaves L2 once for 128 rows
//   (an earlier version split K over the warps of a 32-row block, and x's
//   extra L2 traffic cost it a third of its time). Where 128-row blocks
//   are few, the blocks of a thread-block cluster (2, 4 or 8) split K into
//   contiguous runs and sum their partials through distributed shared
//   memory, each block the rows of its slice, in rank order:
//   deterministic, no atomics, no device workspace. The split is the
//   largest that keeps every block resident at once (plan). x is never
//   held whole in shared memory, so down_proj's 8 x 14336 bf16 (229 KB)
//   needs no special case.
// - Larger M (grouped prefill, k_pad x bucket up to 4096; the extend's 512
//   rows): blocks of 64 tokens x 128 output rows, four warps of 32 tokens x
//   64 rows, tokens the fastest grid axis so that the blocks of one weight
//   tile run together and each weight byte leaves device memory about
//   once. Simple first; not yet fast.
// Capture-safe: nothing is allocated, nothing synchronises, the launch goes
// on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int kSpan = 64;          // k a span: 16-byte int8 loads, 4 mma k-steps
constexpr int kMaxPeriod = 256;    // the largest S staged in shared memory
constexpr int kDecodeStages = 4;   // the decode kernel's ring
constexpr int kDecodeSub = 2;      // spans a decode stage

struct Params {
  const __nv_bfloat16* x;          // [M, K], row stride ldx
  const int8_t* q;                 // [N, K]
  const __nv_bfloat16* scale;      // [N, S]
  __nv_bfloat16* y;                // [M, N]
  int M, N, K, S;
  long long ldx;
};

// A block of WN x WM warps tiles BN output rows x BM tokens (each warp NT
// 16-row tiles x MT 8-token tiles); its warps share one ring of STAGES
// stages of SUB consecutive spans (a stage reads SUB x 64 contiguous bytes
// of each weight row). The blocks of a thread-block cluster (gridDim.z of
// them) split K into contiguous runs of stages and sum their partials
// through distributed shared memory.
template <int NT, int MT, int WN, int WM, int STAGES, int SUB>
struct Shape {
  static constexpr int kThreads = 32 * WN * WM;
  static constexpr int BN = 16 * NT * WN;
  static constexpr int BM = 8 * MT * WM;
  static constexpr int kWBytes = BN * kSpan;           // a span's int8 rows of 64 bytes
  static constexpr int kXBytes = BM * kSpan * 2;       // its bf16 rows of 128 bytes
  static constexpr int kSub = kWBytes + kXBytes;
  static constexpr int kStage = SUB * kSub;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kPartial = BN * BM * 4;         // f32 partial sums
  static constexpr int kMain = kRing > kPartial ? kRing : kPartial;
};

// ---- pieces ------------------------------------------------------------------

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

// The 16-byte position of chunk c (8 bf16) of x row r in its 128-byte ring
// row: a lane reads chunks 2t and 2t + 1 of its row, so the chunks are
// stored even ones first, and odd rows swap the halves; the 8 lanes of a
// quarter warp (rows r, r + 1; t = 0..3) then hit distinct banks.
__device__ __forceinline__ int x_pos(int c, int r) {
  return (((c & 1) << 2) | (c >> 1)) ^ ((r & 1) << 2);
}

// ---- the kernel ---------------------------------------------------------------

template <int NT, int MT, int WN, int WM, int STAGES, int SUB, bool ROW_SCALE>
__global__ void __launch_bounds__(Shape<NT, MT, WN, WM, STAGES, SUB>::kThreads)
    int8_linear_kernel(const Params p) {
  using Sh = Shape<NT, MT, WN, WM, STAGES, SUB>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  const int lr = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * Sh::BN, m0 = blockIdx.x * Sh::BM;
  uint8_t* scales = smem + Sh::kMain;              // [BN][S] bf16 (S > 1)
  // This block's run of stages (SUB spans of 64 k each): the cluster's
  // blocks split them evenly, in order.
  const int stages = (p.K + SUB * kSpan - 1) / (SUB * kSpan), splits = gridDim.z;
  const int first = stages * blockIdx.z / splits;
  const int mine = stages * (blockIdx.z + 1) / splits - first;

  // The run's j-th stage. Consecutive threads copy consecutive 16-byte
  // chunks of a row's SUB x 64 bytes; span s of the stage lands in its own
  // [BN][64] int8 and [BM][128] bf16 tiles.
  auto load = [&](int j) {
    uint8_t* st = smem + (j % STAGES) * Sh::kStage;
    const int k0 = (first + j) * SUB * kSpan;
    for (int c = threadIdx.x; c < Sh::BN * 4 * SUB; c += Sh::kThreads) {
      const int row = c / (4 * SUB), ch = c % (4 * SUB), k = k0 + ch * 16, n = n0 + row;
      const bool ok = n < p.N && k < p.K;
      cp_async_16(st + (ch >> 2) * Sh::kSub + row * kSpan + (ch & 3) * 16,
                  ok ? p.q + (long long)n * p.K + k : p.q, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < Sh::BM * 8 * SUB; c += Sh::kThreads) {
      const int row = c / (8 * SUB), ch = c % (8 * SUB), k = k0 + ch * 8, m = m0 + row;
      const bool ok = m < p.M && k < p.K;
      cp_async_16(st + (ch >> 3) * Sh::kSub + Sh::kWBytes + row * 128 + (x_pos(ch & 7, row) << 4),
                  ok ? p.x + m * p.ldx + k : p.x, ok ? 16 : 0);
    }
  };

  // Scales: a lane's rows are (wn NT + nt) 16 + lr + 8 h. A staged scale
  // row's 16-byte chunk c sits at c ^ (row % 8) when the row holds whole
  // groups of 8 chunks, so the 8 rows a quarter warp reads fall in distinct
  // banks; they are copied with the first stage.
  uint32_t row_scale[NT][2];
  const int swz = p.S % 64 == 0 ? 7 : 0;
  if (!ROW_SCALE) {
    const int chunks = p.S / 8;
    for (int c = threadIdx.x; c < Sh::BN * chunks; c += Sh::kThreads) {
      const int row = c / chunks, ch = c % chunks, n = n0 + row;
      cp_async_16(scales + (row * chunks + (ch ^ (row & swz))) * 16,
                  n < p.N ? p.scale + (long long)n * p.S + ch * 8 : p.scale, n < p.N ? 16 : 0);
    }
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();
  }
  if (ROW_SCALE) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + (wn * NT + nt) * 16 + lr + 8 * h;
        const uint16_t s =
            n < p.N ? *reinterpret_cast<const uint16_t*>(p.scale + n) : uint16_t(0);
        row_scale[nt][h] = uint32_t(s) * 0x10001u;
      }
  }

  float acc[NT][MT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.f;

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // stage j landed for all; stage j - 1's slot is free
    if (j + STAGES - 1 < mine) load(j + STAGES - 1);
    cp_async_commit();

#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const uint32_t st = smem_u32(smem + (j % STAGES) * Sh::kStage + sub * Sh::kSub);
      const uint32_t xs = st + Sh::kWBytes;
      // B fragments of the span's four k-steps: words 2i, 2i + 1 of a token row.
      uint32_t b[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (wm * MT + mt) * 8 + lr;
        const uint4 lo = lds128(xs + r * 128 + (x_pos(2 * t, r) << 4));
        const uint4 hi = lds128(xs + r * 128 + (x_pos(2 * t + 1, r) << 4));
        b[mt][0] = lo.x; b[mt][1] = lo.y; b[mt][2] = lo.z; b[mt][3] = lo.w;
        b[mt][4] = hi.x; b[mt][5] = hi.y; b[mt][6] = hi.z; b[mt][7] = hi.w;
      }
      const int kc = ((((first + j) * SUB + sub) * kSpan + 16 * t) % (ROW_SCALE ? 16 : p.S)) / 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t a[4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wn * NT + nt) * 16 + lr + 8 * h;
          const uint4 w = lds128(st + r * kSpan + t * 16);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          uint32_t sc[8];
          if (ROW_SCALE) {
#pragma unroll
            for (int i = 0; i < 8; ++i) sc[i] = row_scale[nt][h];
          } else {
            const uint32_t srow = smem_u32(scales) + r * p.S * 2;
            const uint4 s0 = lds128(srow + ((kc ^ (r & swz)) << 4));
            const uint4 s1 = lds128(srow + (((kc + 1) ^ (r & swz)) << 4));
            sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
            sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t f = words[i] ^ 0x80808080u;
            a[i][h] = bf16x2_mul(int8_pair<0, 1>(f), sc[2 * i]);
            a[i][2 + h] = bf16x2_mul(int8_pair<2, 3>(f), sc[2 * i + 1]);
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

  // A lane holds rows lr, lr + 8 of each 16-row tile, tokens 2t, 2t + 1 of
  // each 8-token tile: acc[nt][mt][2 h + e] is (row lr + 8 h, token 2t + e).
  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + (wn * NT + nt) * 16 + lr + 8 * (i >> 1);
          const int m = m0 + (wm * MT + mt) * 8 + 2 * t + (i & 1);
          if (n < p.N && m < p.M) p.y[(long long)m * p.N + n] = __float2bfloat16_rn(acc[nt][mt][i]);
        }
    return;
  }
  // Split K: each block parks its partial sums [BN rows][BM tokens] in its
  // own shared memory (the drained ring); after one cluster barrier block r
  // sums rows [r BN / splits, (r + 1) BN / splits) over the cluster's
  // blocks in rank order (deterministic) and writes them; a second barrier
  // keeps every block's partials alive until they have been read.
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (wn * NT + nt) * 16 + lr + 8 * (i >> 1);
        const int m = (wm * MT + mt) * 8 + 2 * t + (i & 1);
        part[r * Sh::BM + m] = acc[nt][mt][i];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = Sh::BN / splits;
  for (int e = threadIdx.x; e < rows * Sh::BM; e += Sh::kThreads) {
    const int r = rank * rows + e / Sh::BM, m = e % Sh::BM;
    float sum = 0.f;
    for (int b = 0; b < splits; ++b) sum += cluster.map_shared_rank(part, b)[r * Sh::BM + m];
    const int n = n0 + r, mg = m0 + m;
    if (n < p.N && mg < p.M) p.y[(long long)mg * p.N + n] = __float2bfloat16_rn(sum);
  }
  cluster.sync();
}

// One instantiation of the kernel: its function, block and shared memory.
template <int NT, int MT, int WN, int WM, int STAGES, int SUB, bool ROW_SCALE>
struct Kernel {
  using Sh = Shape<NT, MT, WN, WM, STAGES, SUB>;
  static constexpr auto fn = &int8_linear_kernel<NT, MT, WN, WM, STAGES, SUB, ROW_SCALE>;
  static int smem(int S) { return Sh::kMain + (ROW_SCALE ? 0 : Sh::BN * S * 2); }
  // Opts in to the most shared memory any scale period needs, once.
  static cudaError_t prepare() {
    static bool opted = false;
    return flash::allow_smem(fn, smem(kMaxPeriod), opted);
  }
  // Blocks resident at once on the current card at this shared memory
  // (the answer for the last one asked is kept: the card does not change).
  static cudaError_t resident(int smem_bytes, int* blocks) {
    static int device = -1, bytes = -1, answer = 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != device || smem_bytes != bytes) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, Sh::kThreads, smem_bytes);
      }
      if (err != cudaSuccess) return err;
      device = dev;
      bytes = smem_bytes;
      answer = per_sm * sms;
    }
    *blocks = answer;
    return cudaSuccess;
  }
};

// The blocks of a cluster that split K when the caller leaves the choice
// to the kernel: a decode shape (M <= 16) doubles its blocks (2, 4, 8)
// while they all stay resident at once (the card's occupancy answer for
// the instantiation) and each keeps at least four stages. A block's first
// loads wait a full memory latency, and a second wave of blocks waits for
// a whole block (at the gate shape 2 blocks a cluster took 29.9 us, 4 took
// 33.5: a second wave).
template <class Kn>
cudaError_t plan(const Params& p, int* splits) {
  *splits = 1;
  cudaError_t err = Kn::prepare();
  if (err != cudaSuccess || p.M > 16) return err;
  int resident = 0;
  err = Kn::resident(Kn::smem(p.S), &resident);
  if (err != cudaSuccess) return err;
  const int blocks = (p.N + Kn::Sh::BN - 1) / Kn::Sh::BN;
  const int stages = (p.K + kDecodeSub * kSpan - 1) / (kDecodeSub * kSpan);
  while (*splits < 8 && 2 * blocks * *splits <= resident && stages / (2 * *splits) >= 4) {
    *splits *= 2;
  }
  return cudaSuccess;
}

template <class Kn>
cudaError_t launch(const Params& p, int splits, cudaStream_t stream) {
  using Sh = typename Kn::Sh;
  cudaError_t err = splits == 0 ? plan<Kn>(p, &splits) : Kn::prepare();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.gridDim = dim3((p.M + Sh::BM - 1) / Sh::BM, (p.N + Sh::BN - 1) / Sh::BN, splits);
  cfg.blockDim = dim3(Sh::kThreads);
  cfg.dynamicSmemBytes = Kn::smem(p.S);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kn::fn, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Calls f with the instantiation for p. Decode (M <= 16): 8 warps of one
// 16-row tile each, 128 rows a block; prefill: 64 tokens x 128 rows, four
// warps of 32 x 64.
template <class F>
cudaError_t with_kernel(const Params& p, F f) {
  if (p.S == 1) {
    if (p.M <= 8) return f(Kernel<1, 1, 8, 1, kDecodeStages, kDecodeSub, true>{});
    if (p.M <= 16) return f(Kernel<1, 2, 8, 1, kDecodeStages, kDecodeSub, true>{});
    return f(Kernel<4, 4, 2, 2, 4, 1, true>{});
  }
  if (p.M <= 8) return f(Kernel<1, 1, 8, 1, kDecodeStages, kDecodeSub, false>{});
  if (p.M <= 16) return f(Kernel<1, 2, 8, 1, kDecodeStages, kDecodeSub, false>{});
  return f(Kernel<4, 4, 2, 2, 4, 1, false>{});
}

Params make_params(const void* x, const void* q, const void* scale, void* y, int M, int N, int K,
                   int S, long long ldx) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const __nv_bfloat16*>(scale);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = M;
  p.N = N;
  p.K = K;
  p.S = S;
  p.ldx = ldx;
  return p;
}

bool valid(int M, int N, int K, int S) {
  return M >= 1 && N >= 16 && K >= 16 && N % 16 == 0 && K % 16 == 0 &&
         (S == 1 || (S % 16 == 0 && S <= kMaxPeriod && K % S == 0));
}

}  // namespace

// The blocks of a cluster that split K for an [M, N] x [N, K] product with
// scale period S when the caller leaves the choice to the kernel (see
// plan), or minus a CUDA error code.
extern "C" int kftpu_int8_linear_splits(int M, int N, int K, int S) {
  if (!valid(M, N, K, S)) return -static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(nullptr, nullptr, nullptr, nullptr, M, N, K, S, K);
  int splits = 1;
  const cudaError_t err =
      with_kernel(p, [&](auto kn) { return plan<decltype(kn)>(p, &splits); });
  return err == cudaSuccess ? splits : -static_cast<int>(err);
}

// y[M, N] = x[M, K] . dequant(q, scale)^T (see the header). ``ldx``: x's
// row stride in elements (>= K, a multiple of 8); q, scale and y contiguous;
// every pointer 16-byte aligned. ``splits``: the blocks of a cluster that
// split K (1, 2, 4 or 8; M <= 16 only), 0 for kftpu_int8_linear_splits'
// choice. Returns the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_int8_linear(const void* x, const void* q, const void* scale, void* y, int M,
                                 int N, int K, int S, long long ldx, int splits, void* stream) {
  if (!valid(M, N, K, S) || ldx < K || ldx % 8 ||
      (splits != 0 && splits != 1 && (M > 16 || (splits != 2 && splits != 4 && splits != 8)))) {
    return cudaErrorInvalidValue;
  }
  const Params p = make_params(x, q, scale, y, M, N, K, S, ldx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_kernel(p, [&](auto kn) { return launch<decltype(kn)>(p, splits, st); }));
}
