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
// quantized: the tensor cores multiply bf16 (W8A16), not int8. One launch
// runs one product, or up to three that read the same x (a group: q/k/v,
// or gate/up), each into its own y: the grid walks every product's
// 128-row tiles, and a block finds its product by the cumulative tile
// counts.
//
// Bound on this card: max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s) with
// bytes = N K + 2 N S + 2 M K + 2 M N. At the decode point, M = 8 (one row
// a slot), bytes: llama3-8b's q/o 5.0 / 5.3 us, k/v 1.25, gate/up/down
// 17.6, lm_head 157.5, 2.26 ms over a decode step's products. A grouped
// prefill of 512 tokens or more, operations: the gate at M = 512 60.8 us.
//
// Decode (M <= 16), int8_linear_decode:
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
//   shared by the block's warps, zero-filled past N, M and K; per-row scales
//   (S = 1) sit in registers. At decode a stage holds two spans, so it
//   reads 128 contiguous bytes of each weight row (a whole L2 line; at 64
//   bytes the lm_head took 286 us against 204), and three stages are in
//   flight while one is computed.
// - A block's 8 warps own one 16-row tile each (128 rows a block) and read
//   the same x span, so x leaves L2 once for 128 rows. Where 128-row blocks
//   are few, the blocks of a thread-block cluster (2, 4 or 8) split K into
//   contiguous runs and sum their partials through distributed shared
//   memory, each block the rows of its slice, in rank order: deterministic,
//   no atomics, no device workspace. The split is the largest that keeps
//   every block resident at once (plan). x is never held whole in shared
//   memory, so down_proj's 8 x 14336 bf16 (229 KB) needs no special case.
// - Per-column scales (S > 1, o_proj's [128 rows, 128] = 32 KB a block)
//   are copied with the first stage, swizzled.
// - A group's products share the grid and the split: q/k/v (48 tiles) is
//   one launch where three paid a block start, a ring fill and a cluster
//   sum each.
// - SwiGLU epilogue (kftpu_int8_linear_swiglu): gate and up, each [F, K]
//   with per-row scales, in one launch whose 128-row tiles hold 64 gate
//   rows (warps 0-3) and the 64 up rows of the same columns (warps 4-7).
//   The epilogue writes h = silu(gate) * up [M, F] in place of gate and up
//   (K9's function, kubeflow_tpu/models/llama.py::Mlp :657, so a decode
//   step's MLP makes no K9 launch): each block parks its sums in shared
//   memory, as the split-K path does; g and u are summed over the
//   cluster's blocks in rank order (or taken as they are with no split),
//   rounded to bf16 where K4 rounds its outputs, and then run through
//   swiglu.cu's forward operation by operation (__fadd_rn, expf,
//   __fdiv_rn, the bf16 rounding, __fmul_rn), so h is bitwise K4 followed
//   by K9. A tile of F / 64 columns: gate/up at F = 14336 is 224 tiles, as
//   the grouped launch's 112 + 112, so the plan picks the same split.
//
// Prefill and extend (M > 16), int8_linear_prefill: TMA + wgmma,
// warp-specialised, bound by operations from M = 512 on.
// - Warpgroup 0, one thread: the producer. It keeps TMA loads in flight
//   over a ring of stages, each the x tile (bf16, 64 k, 128-byte swizzle;
//   tokens past M arrive as zeros) and the int8 weight tile (64 bytes a
//   row, 64-byte swizzle; rows past N and k past K as zeros).
// - Warpgroups 1 and 2: consumers, 64 weight rows each. y^T's tile is
//   W . x^T: the weights are wgmma's A operand from registers, the x tile
//   its K-major B operand through a shared-memory descriptor. A lane
//   dequantizes its own A fragments: for each k-step two 4-byte loads of
//   its rows' int8 (conflict-free under the 64-byte swizzle) and one byte
//   permute give k 2t, 2t + 1, 2t + 8, 2t + 9, wgmma's natural k order
//   (the x tile is TMA's, so the decode kernel's permuted order cannot
//   be used). Each weight is rounded once to bf16(q s), _materialize's
//   rounding: with per-row scales by one FFMA on the byte placed in a
//   float's mantissa (int8_pair_scaled); with per-column ones (S > 1,
//   staged once a block in shared memory, swizzled, two 4-byte loads a
//   k-step) by fma.rn.bf16x2 (-0) on the widened pair.
// - The weights never round-trip through shared memory as bf16. The first
//   design did that (x as A, the dequantized weight as a 128-byte-swizzled
//   B tile written by three dequantizing warps, fence.proxy.async, then
//   wgmma): at M = 512 it took 0.182 ms, its dequantization pass alone
//   0.143, TMA + wgmma alone 0.0996 (PERF.md).
// - Tiles: 128 weight rows by 256 tokens (f32 accumulators: 128 a
//   thread); 128 tokens where 256 would leave half the SMs idle (q/k/v/o
//   at M = 512) or M <= 128; 64 tokens up to M = 64. Tokens are the
//   fastest grid axis, so the blocks of one weight tile run together and
//   each weight byte leaves device memory about once. (Pairs of blocks on
//   neighbouring weight tiles, each multicasting half of the x tile to
//   both, cut a block's L2 reads from 40 to 24 KB a stage but took 0.147
//   ms at M = 512 against 0.098.)
// - A warpgroup converts stage i + 1 while the other's products of stage
//   i run: having issued its own products of stage i, it loads stage
//   i + 1's int8 words (8 registers; their latency hides under its own
//   products), waits for its products and only then rewrites its A
//   registers (16 a stage; 384 threads leave 168 registers a thread, and
//   an n256 wgmma needs 154).
// - Epilogue: each warpgroup stages y's [tokens][64 rows] in the drained
//   ring with transposing stmatrix stores and writes it with one TMA
//   store, which clips the ragged edges (scattered 2-byte stores cost 9 us
//   of 110 at M = 512).
// Capture-safe: nothing is allocated, nothing synchronises, the launch goes
// on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "fused_common.cuh"
#include "hopper_common.cuh"
#include "int8_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;
using namespace int8w;

constexpr int kSpan = 64;          // k a span (decode) or a stage (prefill)
constexpr int kMaxPeriod = 256;    // the largest S staged in shared memory
constexpr int kDecodeStages = 4;   // the decode kernel's ring
constexpr int kDecodeSub = 2;      // spans a decode stage
constexpr int kMaxSegs = 3;        // products a launch

// One product of a launch: its weight, scales and output, and its row
// tiles on the grid, [tile0, tile1).
struct Seg {
  const int8_t* q;                 // [N, K]
  const __nv_bfloat16* scale;      // [N, S]
  __nv_bfloat16* y;                // [M, N]
  int N, S;
  int tile0, tile1;
};

// A launch's products: the kernels' common arguments. ``glu``: seg[0] is
// gate, seg[1] up (same N = F), both writing h = silu(gate) * up to
// seg[0].y; seg[0] owns every tile of F / 64 columns.
struct Params {
  const __nv_bfloat16* x;          // [M, K], row stride ldx
  long long ldx;
  int M, K, nseg;
  int glu;
  Seg seg[kMaxSegs];
};

// The prefill kernel adds its tensor maps; the decode kernel's parameter
// block stays small.
struct PrefillParams : Params {
  CUtensorMap tm_x;                // x in boxes of 64 k x BM tokens
  CUtensorMap tm_w[kMaxSegs];      // q in boxes of 64 k x 128 rows
  CUtensorMap tm_y[kMaxSegs];      // y in boxes of 64 rows x BM tokens
};

// The product that owns row tile ``tile`` of the grid, and its index
// (selected with constant indices: no indexing of the parameter space by a
// register).
__device__ __forceinline__ Seg segment(const Params& p, int tile, int* index = nullptr) {
  Seg sg = p.seg[0];
  int idx = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i) {
    if (i < p.nseg && tile >= p.seg[i].tile0) {
      sg = p.seg[i];
      idx = i;
    }
  }
  if (index != nullptr) *index = idx;
  return sg;
}

template <class Map>
__device__ __forceinline__ const CUtensorMap* map_of(const Map (&maps)[kMaxSegs], int index) {
  return index == 0 ? &maps[0] : index == 1 ? &maps[1] : &maps[2];
}

// ---- pieces ------------------------------------------------------------------

// bf16x2 of q * s for two int8 bytes (lo, hi) of a word whose bytes were
// flipped to u = q + 128, in five instructions a pair where int8_pair
// and bf16x2_mul take six: the byte lands in the low mantissa byte of
// 2^23, and fma(s, 2^23 + u, -s (2^23 + 128)) is s q exactly (s has 8
// significant bits, so s (2^23 + 128) needs 24, f32's, and s q 15),
// rounded once to bf16 by the pack: _materialize's bf16(q s). ``neg_sc``
// is -s (2^23 + 128).
template <int LO, int HI>
__device__ __forceinline__ uint32_t int8_pair_scaled(uint32_t flipped, float s, float neg_sc) {
  const float lo = fmaf(s, __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | LO)), neg_sc);
  const float hi = fmaf(s, __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | HI)), neg_sc);
  return flash::pack_bf16(lo, hi);
}

// ---- decode (M <= 16): mma.sync over cp.async rings --------------------------

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

template <int NT, int MT, int WN, int WM, int STAGES, int SUB, bool ROW_SCALE, bool GLU>
__global__ void __launch_bounds__(Shape<NT, MT, WN, WM, STAGES, SUB>::kThreads)
    int8_linear_decode(const Params p) {
  using Sh = Shape<NT, MT, WN, WM, STAGES, SUB>;
  static_assert(!GLU || (ROW_SCALE && NT == 1 && WN == 8), "GLU: 8 warps of 16 rows, row scales");
  constexpr int kHalf = Sh::BN / 2;    // GLU: a tile's columns (gate rows, then up rows)
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  const int lr = lane >> 2, t = lane & 3;
  const Seg sg = segment(p, blockIdx.y);
  const int n0 = GLU ? blockIdx.y * kHalf : (blockIdx.y - sg.tile0) * Sh::BN;
  const int m0 = blockIdx.x * Sh::BM;
  // Block row r's weight row: row n0 + r of the product, or (GLU) row
  // n0 + r % 64 of gate (r < 64) or of up.
  auto weight_row = [&](int r, int* n) -> int {
    *n = GLU ? n0 + (r % kHalf) : n0 + r;
    return GLU && r >= kHalf ? 1 : 0;
  };
  // This block's run of stages (SUB spans of 64 k each): the cluster's
  // blocks split them evenly, in order.
  const int stages = (p.K + SUB * kSpan - 1) / (SUB * kSpan), splits = gridDim.z;
  const int first = stages * blockIdx.z / splits;
  const int mine = stages * (blockIdx.z + 1) / splits - first;
  uint8_t* scales = smem + Sh::kMain;              // S > 1: [BN][S] bf16

  // The run's j-th stage. Consecutive threads copy consecutive 16-byte
  // chunks of a row's SUB x 64 bytes; span s of the stage lands in its own
  // [BN][64] int8 and [BM][128] bf16 tiles.
  auto load = [&](int j) {
    uint8_t* st = smem + (j % STAGES) * Sh::kStage;
    const int k0 = (first + j) * SUB * kSpan;
    for (int c = threadIdx.x; c < Sh::BN * 4 * SUB; c += Sh::kThreads) {
      const int row = c / (4 * SUB), ch = c % (4 * SUB), k = k0 + ch * 16;
      int n;
      const int8_t* q = weight_row(row, &n) ? p.seg[1].q : sg.q;
      const bool ok = n < sg.N && k < p.K;
      cp_async_16(st + (ch >> 2) * Sh::kSub + row * kSpan + (ch & 3) * 16,
                  ok ? q + (long long)n * p.K + k : sg.q, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < Sh::BM * 8 * SUB; c += Sh::kThreads) {
      const int row = c / (8 * SUB), ch = c % (8 * SUB), k = k0 + ch * 8, m = m0 + row;
      const bool ok = m < p.M && k < p.K;
      cp_async_16(st + (ch >> 3) * Sh::kSub + Sh::kWBytes + row * 128 + (x_pos(ch & 7, row) << 4),
                  ok ? p.x + m * p.ldx + k : p.x, ok ? 16 : 0);
    }
  };

  // Scales: a lane's rows are (wn NT + nt) 16 + lr + 8 h. Per-column ones
  // (S > 1) are copied with the first stage: a staged row's 16-byte chunk
  // c sits at c ^ (row % 8) when the row holds whole groups of 8 chunks,
  // so the 8 rows a quarter warp reads fall in distinct banks. (Loading
  // them once a cluster by TMA multicast, behind a cluster barrier, took
  // o_proj 19.3 us against 18.2.) Per-row ones sit in registers.
  const int swz = sg.S % 64 == 0 ? 7 : 0;
  if (!ROW_SCALE) {
    const int chunks = sg.S / 8;
    for (int c = threadIdx.x; c < Sh::BN * chunks; c += Sh::kThreads) {
      const int row = c / chunks, ch = c % chunks, n = n0 + row;
      cp_async_16(scales + (row * chunks + (ch ^ (row & swz))) * 16,
                  n < sg.N ? sg.scale + (long long)n * sg.S + ch * 8 : sg.scale,
                  n < sg.N ? 16 : 0);
    }
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();
  }
  uint32_t row_scale[NT][2];
  if (ROW_SCALE) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int n;
        const __nv_bfloat16* scale =
            weight_row((wn * NT + nt) * 16 + lr + 8 * h, &n) ? p.seg[1].scale : sg.scale;
        const uint16_t s =
            n < sg.N ? *reinterpret_cast<const uint16_t*>(scale + n) : uint16_t(0);
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
      const int kc = ((((first + j) * SUB + sub) * kSpan + 16 * t) % (ROW_SCALE ? 16 : sg.S)) / 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t a[4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wn * NT + nt) * 16 + lr + 8 * h;
          const uint4 w = lds128(st + r * kSpan + t * 16);
          uint32_t sc[8];
          if (ROW_SCALE) {
#pragma unroll
            for (int i = 0; i < 8; ++i) sc[i] = row_scale[nt][h];
          } else {
            // Chunks kc, kc + 1 (kc even: one group of 8) of row r.
            const uint32_t row = smem_u32(scales) + r * sg.S * 2;
            const int c0 = kc ^ (r & swz);
            const uint4 s0 = lds128(row + (c0 << 4));
            const uint4 s1 = lds128(row + ((c0 ^ 1) << 4));
            sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
            sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
          }
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

  // A lane holds rows lr, lr + 8 of each 16-row tile, tokens 2t, 2t + 1 of
  // each 8-token tile: acc[nt][mt][2 h + e] is (row lr + 8 h, token 2t + e).
  if constexpr (GLU) {
    // Every block parks its sums [BN rows][BM tokens]; block r of the
    // cluster finishes columns [r 64 / splits, (r + 1) 64 / splits) of
    // the tile: column c's gate sum is row c, its up sum row 64 + c, each
    // summed over the blocks in rank order as the split path sums (no
    // split: the block's own sums, as the path with no split writes them).
    cp_async_wait<0>();
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wn * 16 + lr + 8 * (i >> 1);
        const int m = (wm * MT + mt) * 8 + 2 * t + (i & 1);
        part[r * Sh::BM + m] = acc[0][mt][i];
      }
    const int cols = kHalf / splits;
    if (splits == 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < kHalf * Sh::BM; e += Sh::kThreads) {
        const int c = e % kHalf, m = e / kHalf, n = n0 + c, mg = m0 + m;
        if (n < sg.N && mg < p.M) {
          reinterpret_cast<uint16_t*>(sg.y)[(long long)mg * sg.N + n] =
              swiglu_of_sums(part[c * Sh::BM + m], part[(kHalf + c) * Sh::BM + m]);
        }
      }
      return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int e = threadIdx.x; e < cols * Sh::BM; e += Sh::kThreads) {
      const int c = rank * cols + e % cols, m = e / cols;
      float g = 0.f, u = 0.f;
      for (int b = 0; b < splits; ++b) {
        const float* pb = cluster.map_shared_rank(part, b);
        g += pb[c * Sh::BM + m];
        u += pb[(kHalf + c) * Sh::BM + m];
      }
      const int n = n0 + c, mg = m0 + m;
      if (n < sg.N && mg < p.M) {
        reinterpret_cast<uint16_t*>(sg.y)[(long long)mg * sg.N + n] = swiglu_of_sums(g, u);
      }
    }
    cluster.sync();
    return;
  }
  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + (wn * NT + nt) * 16 + lr + 8 * (i >> 1);
          const int m = m0 + (wm * MT + mt) * 8 + 2 * t + (i & 1);
          if (n < sg.N && m < p.M) sg.y[(long long)m * sg.N + n] = __float2bfloat16_rn(acc[nt][mt][i]);
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
    if (n < sg.N && mg < p.M) sg.y[(long long)mg * sg.N + n] = __float2bfloat16_rn(sum);
  }
  cluster.sync();
}

// ---- prefill (M > 16): TMA + wgmma, the weights as the register A operand --

// 128 weight rows (two consumer warpgroups of 64) x BM tokens (64, 128 or
// 256: wgmma's N). y^T's tile is W . x^T: W dequantized straight into the
// A fragments, x the K-major B operand from the TMA ring. Raw stages hold
// the x tile (128-byte swizzle) and the int8 weight tile (64 bytes a row,
// 64-byte swizzle: chunk c of row r at c ^ ((r / 2) % 4)); per-column
// scales (S > 1) sit after the ring, [128 rows][S], staged once.
template <int BM_, bool ROW_SCALE>
struct Prefill {
  static constexpr int BN = 128;
  static constexpr int BM = BM_;
  static constexpr int kThreads = 384;
  static constexpr int kXBytes = BM * 128;
  static constexpr int kWBytes = BN * kSpan;
  static constexpr int kRaw = kXBytes + kWBytes;
  static constexpr int kScales = ROW_SCALE ? 0 : BN * kMaxPeriod * 2;
  static constexpr int kRawStages = (ROW_SCALE || BM < 256) ? 5 : 4;
  // 1024 bytes of slack to align the tiles, the ring, the scales, the barriers.
  static constexpr int kSmem = 1024 + kRawStages * kRaw + kScales + 16 * kRawStages;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static_assert(kRaw % 1024 == 0, "tiles must stay 1024-byte aligned");
  static_assert(2 * BM * 128 <= kRawStages * kRaw, "the epilogue stages y in the ring");
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

template <int BM, bool ROW_SCALE>
__global__ void __launch_bounds__(Prefill<BM, ROW_SCALE>::kThreads, 1)
    int8_linear_prefill(const __grid_constant__ PrefillParams p) {
  using T = Prefill<BM, ROW_SCALE>;
  constexpr int R = T::kRawStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* raw = align1024(smem_raw);                    // R x (x tile, int8 tile)
  uint8_t* scales = raw + R * T::kRaw;                   // S > 1: [128][S] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + T::kScales);
  uint64_t* empty = full + R;

  int si;
  const Seg sg = segment(p, blockIdx.y, &si);
  const int n0 = (blockIdx.y - sg.tile0) * T::BN, m0 = blockIdx.x * BM;
  const int nk = (p.K + kSpan - 1) / kSpan;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);      // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<T::kProducerRegs>();
    if (tid == 0) {
      const CUtensorMap* tw = map_of(p.tm_w, si);
      prefetch_tensor_map(&p.tm_x);
      prefetch_tensor_map(tw);
      for (int i = 0; i < nk; ++i) {
        const int s = i % R;
        uint8_t* st = raw + s * T::kRaw;
        mbar_wait(&empty[s], ((i / R) & 1) ^ 1);         // the first R pass at once
        mbar_arrive_expect_tx(&full[s], T::kRaw);
        tma_load_2d(st, &p.tm_x, &full[s], i * kSpan, m0);
        tma_load_2d(st + T::kXBytes, tw, &full[s], i * kSpan, n0);
      }
    }
  } else {
    // Consumer warpgroup c: weight rows n0 + 64 c .. + 63. A lane's A
    // fragment rows are 16 warp + g + 8 h; for k-step ks its k are 2t, 2t + 1
    // (a[ks][h]) and 2t + 8, 2t + 9 (a[ks][2 + h]), the natural order the
    // descriptor's B expects: two 4-byte loads of the row's k-step chunk
    // hold them (the 64-byte swizzle puts a warp's 16 words in 16 banks),
    // and one byte permute gathers them.
    reg_alloc<T::kConsumerRegs>();
    const int c = wg - 1, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
    const bool swizzled = sg.S % 64 == 0;
    float row_scale[2], row_neg_sc[2];       // s and -s (2^23 + 128) of rows h
    if (ROW_SCALE) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 64 * c + 16 * warp + g + 8 * h;
        const uint16_t sv =
            n < sg.N ? *reinterpret_cast<const uint16_t*>(sg.scale + n) : uint16_t(0);
        row_scale[h] = __uint_as_float(uint32_t(sv) << 16);
        row_neg_sc[h] = -row_scale[h] * 8388736.f;
      }
    } else {
      // The tile's scales, once: 16-byte chunk ch of row r at ch ^ (r % 8)
      // within its group of 8 when S is a multiple of 64, so the 8 rows of
      // a warp's loads fall in distinct banks.
      const int chunks = sg.S / 8, swz = swizzled ? 7 : 0;
      for (int e = threadIdx.x - 128; e < T::BN * chunks; e += 256) {
        const int row = e / chunks, ch = e % chunks, n = n0 + row;
        const uint4 v =
            n < sg.N ? *reinterpret_cast<const uint4*>(sg.scale + (long long)n * sg.S + ch * 8)
                     : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(scales + (row * chunks + (ch ^ (row & swz))) * 16) = v;
      }
      named_bar_sync(1, 256);
    }
    float acc[BM / 2];
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[e] = 0.f;
    // The int8 words of a stage: f[ks][h] holds k 2t, 2t + 1, 2t + 8, 2t + 9
    // of row h's k-step ks, flipped to q + 128.
    uint32_t f[4][2];
    auto fetch = [&](int i) {
      const int s = i % R;
      mbar_wait(&full[s], (i / R) & 1);
      const uint32_t q8 = smem_u32(raw + s * T::kRaw) + T::kXBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * c + 16 * warp + g + 8 * h;
          const uint32_t chunk = q8 + r * kSpan + ((ks ^ ((r >> 1) & 3)) << 4) + 4 * (t >> 1);
          f[ks][h] = __byte_perm(lds32(chunk), lds32(chunk + 8), sel) ^ 0x80808080u;
        }
    };
    fetch(0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % R;
      const uint32_t xb = smem_u32(raw + s * T::kRaw);
      uint32_t a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * c + 16 * warp + g + 8 * h;
          if (ROW_SCALE) {
            a[ks][h] = int8_pair_scaled<0, 1>(f[ks][h], row_scale[h], row_neg_sc[h]);
            a[ks][2 + h] = int8_pair_scaled<2, 3>(f[ks][h], row_scale[h], row_neg_sc[h]);
          } else {
            const int o = (i * kSpan + 16 * ks) % sg.S;
            const int swz = swizzled ? (r & 7) : 0;
            const uint32_t srow = smem_u32(scales) + r * sg.S * 2 + 4 * t;
            a[ks][h] = bf16x2_mul(int8_pair<0, 1>(f[ks][h]), lds32(srow + (((o >> 3) ^ swz) << 4)));
            a[ks][2 + h] =
                bf16x2_mul(int8_pair<2, 3>(f[ks][h]), lds32(srow + ((((o >> 3) + 1) ^ swz) << 4)));
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_rs_n<BM>(acc, a[ks], sw128_desc(xb + ks * 32, 16, 1024));
      }
      wgmma_commit();
      if (i + 1 < nk) fetch(i + 1);
      // The A registers are rewritten next stage: wait for the products
      // (the other warpgroup's keep the tensor cores busy meanwhile; two
      // half stages in flight, 16 registers each way, lost: 0.124 against
      // 0.109 ms at M = 512).
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_operands(acc);
    // Epilogue: y's [BM tokens][64 rows] of this warpgroup, staged in the
    // drained ring (the 128-byte swizzle: the 16-byte chunk of rows 8 q ..
    // + 7 of token m at q ^ (m % 8)) by transposing stmatrix stores, then
    // one TMA store, which clips tokens past M and rows past N. acc[4 j +
    // 2 h + e] is (weight row 16 warp + g + 8 h, token 8 j + 2 t + e).
    named_bar_sync(1, 256);            // both warpgroups are done with the ring
    uint8_t* stage = raw + c * (BM * 128);
    const int q = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int j = 0; j < BM / 8; j += 2) {
      const int m = 8 * (j + (q >> 1)) + rr, chunk = 2 * warp + (q & 1);
      stmatrix_x4_trans(smem_u32(stage) + m * 128 + ((chunk ^ (m & 7)) << 4),
                        flash::pack_bf16(acc[4 * j], acc[4 * j + 1]),
                        flash::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                        flash::pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                        flash::pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
    }
    fence_proxy_async();               // the TMA store reads what stmatrix wrote
    named_bar_sync(2 + c, 128);
    if (tid == 0) {
      tma_store_2d(map_of(p.tm_y, si), stage, n0 + 64 * c, m0);
      tma_store_commit();
      tma_store_wait_read();           // the block's shared memory outlives the read
    }
  }
}

// ---- host --------------------------------------------------------------------

// The decode kernel's instantiation: its function, block and shared memory.
template <int NT, int MT, int WN, int WM, int STAGES, int SUB, bool ROW_SCALE, bool GLU = false>
struct Decode {
  using Sh = Shape<NT, MT, WN, WM, STAGES, SUB>;
  static constexpr bool kDecode = true;
  static constexpr int BN = Sh::BN, BM = Sh::BM, kThreads = Sh::kThreads;
  using P = Params;
  static constexpr auto fn = &int8_linear_decode<NT, MT, WN, WM, STAGES, SUB, ROW_SCALE, GLU>;
  static int smem(int S) { return Sh::kMain + (ROW_SCALE ? 0 : BN * S * 2); }
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
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem_bytes);
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

// The prefill kernel's instantiation.
template <int BM_, bool ROW_SCALE>
struct PrefillKernel {
  using T = Prefill<BM_, ROW_SCALE>;
  static constexpr bool kDecode = false;
  static constexpr int BN = T::BN, BM = T::BM, kThreads = T::kThreads;
  using P = PrefillParams;
  static constexpr auto fn = &int8_linear_prefill<BM_, ROW_SCALE>;
  static cudaError_t prepare() {
    static bool opted = false;
    return flash::allow_smem(fn, T::kSmem, opted);
  }
};

int total_tiles(const Params& p) { return p.seg[p.nseg - 1].tile1; }

int max_period(const Params& p) {
  int s = 1;
  for (int i = 0; i < p.nseg; ++i) s = p.seg[i].S > s ? p.seg[i].S : s;
  return s;
}

// Lays the products' row tiles of BN rows one after the other on the grid
// (glu: seg[0]'s tiles of BN / 2 columns, each holding gate's and up's
// rows; seg[1] owns none).
void set_tiles(Params& p, int bn) {
  if (p.glu) {
    const int tiles = (p.seg[0].N + bn / 2 - 1) / (bn / 2);
    p.seg[0].tile0 = 0;
    p.seg[0].tile1 = p.seg[1].tile0 = p.seg[1].tile1 = tiles;
    return;
  }
  int tile = 0;
  for (int i = 0; i < p.nseg; ++i) {
    p.seg[i].tile0 = tile;
    tile += (p.seg[i].N + bn - 1) / bn;
    p.seg[i].tile1 = tile;
  }
}

// The blocks of a cluster that split K when the caller leaves the choice
// to the kernel: a decode shape (M <= 16) doubles its blocks (2, 4, 8)
// while they all stay resident at once (the card's occupancy answer for
// the instantiation) and each keeps at least four stages. A block's first
// loads wait a full memory latency, and a second wave of blocks waits for
// a whole block (at the gate shape 2 blocks a cluster took 29.9 us, 4 took
// 33.5: a second wave). A group plans over all its products' tiles.
template <class Kn>
cudaError_t plan(Params& p, int* splits) {
  *splits = 1;
  cudaError_t err = Kn::prepare();
  if (err != cudaSuccess) return err;
  if constexpr (Kn::kDecode) {
    int resident = 0;
    err = Kn::resident(Kn::smem(max_period(p)), &resident);
    if (err != cudaSuccess) return err;
    set_tiles(p, Kn::BN);
    const int blocks = total_tiles(p);
    const int stages = (p.K + kDecodeSub * kSpan - 1) / (kDecodeSub * kSpan);
    while (*splits < 8 && 2 * blocks * *splits <= resident && stages / (2 * *splits) >= 4) {
      *splits *= 2;
    }
  }
  return cudaSuccess;
}

template <class Kn>
cudaError_t launch(Params& p, int splits, cudaStream_t stream) {
  cudaError_t err = splits == 0 ? plan<Kn>(p, &splits) : Kn::prepare();
  if (err != cudaSuccess) return err;
  set_tiles(p, Kn::BN);
  typename Kn::P kp;
  static_cast<Params&>(kp) = p;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(Kn::kThreads);
  cfg.stream = stream;
  cfg.gridDim = dim3((p.M + Kn::BM - 1) / Kn::BM, total_tiles(p), splits);
  if constexpr (Kn::kDecode) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.dynamicSmemBytes = Kn::smem(max_period(p));
  } else {
    cfg.dynamicSmemBytes = Kn::T::kSmem;
    if (!encode_2d(&kp.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.K, p.M,
                   static_cast<uint64_t>(p.ldx) * 2, 64, Kn::BM, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
    for (int i = 0; i < p.nseg; ++i) {
      const Seg& sg = p.seg[i];
      if (!encode_2d(&kp.tm_w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.q, p.K, sg.N, p.K, 64,
                     Kn::BN, CU_TENSOR_MAP_SWIZZLE_64B) ||
          !encode_2d(&kp.tm_y[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sg.y, sg.N, p.M,
                     static_cast<uint64_t>(sg.N) * 2, 64, Kn::BM, CU_TENSOR_MAP_SWIZZLE_128B)) {
        return cudaErrorInvalidValue;
      }
    }
  }
  err = cudaLaunchKernelEx(&cfg, Kn::fn, kp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The card's SMs (asked once: the card does not change).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// The prefill's tokens a tile: 64 up to M = 64, 128 up to M = 128 or where
// 256-token tiles would leave half the SMs idle (q/k/v/o at M = 512: 64
// tiles), else 256, which dequantize each weight for twice the tokens.
int prefill_tokens(const Params& p) {
  if (p.M <= 64) return 64;
  int tiles = 0;
  for (int i = 0; i < p.nseg; ++i) tiles += (p.seg[i].N + 127) / 128;
  return p.M <= 128 || 2LL * ((p.M + 255) / 256) * tiles <= sm_count() ? 128 : 256;
}

// Calls f with the instantiation for p. Decode (M <= 16): 8 warps of one
// 16-row tile each, 128 rows a block. Prefill: 128 weight rows by 64, 128
// or 256 tokens (prefill_tokens).
template <class F, bool ROW_SCALE>
cudaError_t with_scales(const Params& p, F f) {
  if (p.M <= 8) return f(Decode<1, 1, 8, 1, kDecodeStages, kDecodeSub, ROW_SCALE>{});
  if (p.M <= 16) return f(Decode<1, 2, 8, 1, kDecodeStages, kDecodeSub, ROW_SCALE>{});
  switch (prefill_tokens(p)) {
    case 64: return f(PrefillKernel<64, ROW_SCALE>{});
    case 128: return f(PrefillKernel<128, ROW_SCALE>{});
    default: return f(PrefillKernel<256, ROW_SCALE>{});
  }
}

template <class F>
cudaError_t with_kernel(const Params& p, F f) {
  return p.seg[0].S == 1 ? with_scales<F, true>(p, f) : with_scales<F, false>(p, f);
}

// The SwiGLU epilogue's instantiation (M <= 16, per-row scales): the
// decode kernel's shapes.
template <class F>
cudaError_t with_glu_kernel(const Params& p, F f) {
  if (p.M <= 8) return f(Decode<1, 1, 8, 1, kDecodeStages, kDecodeSub, true, true>{});
  return f(Decode<1, 2, 8, 1, kDecodeStages, kDecodeSub, true, true>{});
}

bool valid_seg(int N, int K, int S) {
  return N >= 16 && N % 16 == 0 && (S == 1 || (S % 16 == 0 && S <= kMaxPeriod && K % S == 0));
}

// The launch's parameters, or false when a shape is refused: every
// product N and K multiples of 16, S of 1 or a multiple of 16 up to 256
// dividing K, all S = 1 or all S > 1; x's row stride >= K and a multiple
// of 8.
bool make_params(Params* p, const void* x, int M, int K, long long ldx, int nseg,
                 const void* const* q, const void* const* scale, void* const* y, const int* N,
                 const int* S) {
  if (M < 1 || K < 16 || K % 16 || ldx < K || ldx % 8 || nseg < 1 || nseg > kMaxSegs) {
    return false;
  }
  *p = Params{};
  p->x = static_cast<const __nv_bfloat16*>(x);
  p->ldx = ldx;
  p->M = M;
  p->K = K;
  p->nseg = nseg;
  for (int i = 0; i < nseg; ++i) {
    if (!valid_seg(N[i], K, S[i]) || (S[i] == 1) != (S[0] == 1)) return false;
    Seg& sg = p->seg[i];
    sg.q = static_cast<const int8_t*>(q[i]);
    sg.scale = static_cast<const __nv_bfloat16*>(scale[i]);
    sg.y = static_cast<__nv_bfloat16*>(y[i]);
    sg.N = N[i];
    sg.S = S[i];
  }
  return true;
}

bool valid_splits(int M, int splits) {
  return splits == 0 || splits == 1 || (M <= 16 && (splits == 2 || splits == 4 || splits == 8));
}

}  // namespace

// The blocks of a cluster that split K for an [M, N] x [N, K] product with
// scale period S when the caller leaves the choice to the kernel (see
// plan; 1 for M > 16), or minus a CUDA error code.
extern "C" int kftpu_int8_linear_splits(int M, int N, int K, int S) {
  const void* none[1] = {nullptr};
  void* out[1] = {nullptr};
  Params p;
  if (!make_params(&p, nullptr, M, K, K, 1, none, none, out, &N, &S)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int splits = 1;
  const cudaError_t err =
      with_kernel(p, [&](auto kn) { return plan<decltype(kn)>(p, &splits); });
  return err == cudaSuccess ? splits : -static_cast<int>(err);
}

// ``nseg`` (1 to 3) products of the same x in one launch: y[i] [M, N[i]] =
// x . dequant(q[i], scale[i])^T, each argument as kftpu_int8_linear's; S
// all 1 or all > 1. ``splits`` applies to every product.
extern "C" int kftpu_int8_linear_group(const void* x, int M, int K, long long ldx, int nseg,
                                       const void* const* q, const void* const* scale,
                                       void* const* y, const int* N, const int* S, int splits,
                                       void* stream) {
  Params p;
  if (!make_params(&p, x, M, K, ldx, nseg, q, scale, y, N, S) || !valid_splits(M, splits)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_kernel(p, [&](auto kn) { return launch<decltype(kn)>(p, splits, st); }));
}

// y[M, N] = x[M, K] . dequant(q, scale)^T (see the header). ``ldx``: x's
// row stride in elements (>= K, a multiple of 8); q, scale and y contiguous;
// every pointer 16-byte aligned. ``splits``: the blocks of a cluster that
// split K (1, 2, 4 or 8; M <= 16 only), 0 for kftpu_int8_linear_splits'
// choice. Returns the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_int8_linear(const void* x, const void* q, const void* scale, void* y, int M,
                                 int N, int K, int S, long long ldx, int splits, void* stream) {
  return kftpu_int8_linear_group(x, M, K, ldx, 1, &q, &scale, &y, &N, &S, splits, stream);
}

// h[M, F] = silu(x . Wg^T) * (x . Wu^T) in one launch (the SwiGLU
// epilogue, see the header): gate_q, up_q int8 [F, K] and gate_scale,
// up_scale bf16 [F, 1] (per-row scales), h bf16 [M, F] contiguous; M <=
// 16; other arguments as kftpu_int8_linear's (``splits`` applies to both
// halves; 0 for kftpu_int8_linear_splits' choice for the tile count).
// Bitwise kftpu_int8_linear_group of gate and up at the same split, then
// kftpu_swiglu_fwd. Returns the CUDA error code of the launch.
extern "C" int kftpu_int8_linear_swiglu(const void* x, int M, int K, long long ldx,
                                        const void* gate_q, const void* gate_scale,
                                        const void* up_q, const void* up_scale, void* h, int F,
                                        int splits, void* stream) {
  const void* q[2] = {gate_q, up_q};
  const void* scale[2] = {gate_scale, up_scale};
  void* y[2] = {h, h};
  const int N[2] = {F, F};
  const int S[2] = {1, 1};
  Params p;
  if (M > 16 || !make_params(&p, x, M, K, ldx, 2, q, scale, y, N, S) ||
      !valid_splits(M, splits)) {
    return cudaErrorInvalidValue;
  }
  p.glu = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_glu_kernel(p, [&](auto kn) { return launch<decltype(kn)>(p, splits, st); }));
}
