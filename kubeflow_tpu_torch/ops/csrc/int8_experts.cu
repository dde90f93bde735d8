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
// Both kernels are fed by TMA: one producer thread keeps the loads of a
// ring of stages in flight on mbarriers (a full barrier a stage that counts
// the bytes, an empty one that counts the consumers' releases), and the
// compute warps neither issue copies nor meet at a block-wide barrier. 3-D
// tensor maps over [E, R, K], [E, N, K] and [E, R, N] zero-fill (or clip,
// on the store) a tile past R, N or K inside its own expert. Each weight
// is widened exactly from int8 to bf16 by byte permutes and multiplied by
// its scale with one rounding (fma.rn.bf16x2 with -0), as K4 does.
//
// - Decode rows (R <= 16), int8_experts_decode: one block holds 16 weight
//   rows for a group of 8 experts over all of K, a compute warp an expert,
//   so a scale byte leaves device memory once and reaches the SM once (a
//   step reads 1.25 bytes a weight; a block an (expert, tile) would bring
//   each scale tile into the SMs 8 times). A stage is one 64-k span: the
//   [16 x 64] scale tile, the int8 tiles of the 8 experts and their x rows,
//   three TMA loads (the q and x boxes span the 8 experts), 12 stages in
//   the ring. The weights are the A operand of mma.sync m16n8k16, x^T the
//   B operand; a lane's k slots are permuted alike in A and B so that it
//   reads 16 consecutive int8 of each of its rows, their 16 scales and 16
//   bf16 of its token row with 16-byte loads (chunks 2t and 2t + 1 of a
//   128-byte row, at the TMA's 128-byte swizzle positions c ^ (r % 8): a
//   quarter warp's 8 loads hit distinct banks). 16-row blocks give
//   gate/up 896 blocks, 6.8 waves on 132 SMs (32-row blocks: 3.4 waves, 6 %
//   slower; 16 compute warps a 32-row block, two an expert, no faster).
// - More rows (prefill groups, extend chunks), int8_experts_tiled: TMA +
//   wgmma, warp-specialised as K4's prefill kernel (int8_linear.cu). A
//   block is (expert, 128 weight rows, BM = 64, 128 or 256 tokens); its
//   two consumer warpgroups (64 rows each) compute y^T = W . x^T with the
//   weights dequantized straight into wgmma's register A operand and the x
//   tile its K-major B operand from shared memory. A stage holds three TMA
//   tiles: x (128-byte swizzle), the int8 rows (64 bytes a row, 64-byte
//   swizzle) and the bf16 scale rows of the same 128 x 64 span (128-byte
//   swizzle; a lane reads its two scale pairs of a k-step and row with two
//   4-byte loads, the 8 rows x 4 lanes of a warp on distinct banks).
// - The scale tile is the same for every expert. Where x of all experts
//   (2 E R K bytes) is small beside the L2, the grid runs experts fastest,
//   so the 8 blocks of a row tile run together and its scale tile leaves
//   device memory once (37 rows: 0.28 against 0.46 ms). A prefill group's
//   x (84 MB) runs token tiles fastest, so each expert's x stays in the L2
//   while its row tiles pass. (Thread-block clusters of 2-8 experts that
//   multicast the scale tile by TMA, and pairs of row tiles sharing x, were
//   slower at every case: PERF.md.)
// - Tokens a tile by R (tile_tokens): the fewest padded tokens plus a
//   tile's fixed cost of dequantizing its weights, so an extend chunk's
//   17-128 rows do not run in 256-token tiles of zeros. The epilogue
//   stages y^T in the drained ring with transposing stmatrix stores and
//   writes it with one TMA store, as K4's does.
// - Gate and up at decode rows with SwiGLU, int8_experts_swiglu_decode
//   (C entry kftpu_int8_experts_swiglu): the gather of the expert rows
//   (K13), the gate and up products and K9 in one launch, bitwise that
//   chain. It replaces the XLA fusions of
//   kubeflow_tpu/parallel/moe.py::_gather_in (:158-165) and of
//   kubeflow_tpu/models/mixtral.py:111 (nn.silu(gate) * up) at a decode
//   step's rows. The decode kernel's design, a block 8 gate rows and the
//   8 up rows of the same columns for a group of 8 experts (the
//   m16n8k16 A tile's rows 0-7 gate, 8-15 up; 1792 blocks at F = 14336,
//   two an SM, each a ring of half the shared memory, so one block's
//   loads run while the other starts or drains): a stage is both scale
//   boxes, both int8 boxes and the 64-k span of all T token rows of x
//   [T, K] (T <= 256, one box), five TMA loads; each consumer reads its
//   expert's rows from that tile by slot_tok and multiplies its B
//   fragment by the slot's slot_valid (0 or 1, exact, as K13 does), so a
//   sum runs over the same products in the same k order as a separate
//   launch's. (A TMA load a gathered row, 8 R a stage, left the launch
//   bound by the rate the TMA unit takes loads: 1.19 ms at R = 4, 3.7 at
//   R = 16, against 0.40 for the four launches it replaces; one block an
//   SM 0.400, persistent blocks 0.389, two blocks an SM 0.387 at R = 4:
//   kernel_ab.py.) A lane holds gate and up of one column and two tokens
//   (acc[mt][0..1] and acc[mt][2..3]) and writes swiglu_of_sums of them:
//   no exchange through shared memory. Bound: both products' bytes,
//   1174.4 MB at Mixtral-8x7b's decode step (0.3506 ms).
// Capture-safe: nothing is allocated, nothing synchronises, the launch goes
// on the caller's stream (the tensor maps are kernel parameters).
// Deterministic: no atomics, a fixed order of sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "int8_common.cuh"

namespace {

using namespace hopper;
using namespace int8w;

constexpr int kSpan = 64;          // k a stage
constexpr int kMaxSmem = 232448;   // a block's shared memory on this card

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The launch's operands: tensor maps over x [E, R, K], q [E, N, K], the
// scale [N, K] and y [E, R, N] (the tiled kernel's store), y's pointer (the
// decode kernel's stores) and the shape; ``experts_first``: the tiled grid
// runs experts fastest (x: experts, y: token tiles, z: row tiles), else
// token tiles fastest (x: token tiles, y: row tiles, z: experts).
struct Params {
  CUtensorMap tm_x, tm_q, tm_s, tm_y;
  __nv_bfloat16* y;
  int E, R, N, K;
  int experts_first;
};

// ---- decode rows: a group of 8 experts a block --------------------------------

constexpr int G = 8;   // experts a decode block, a compute warp each

template <int MT>
struct Decode {
  static constexpr int BN = 16;                  // weight rows a block
  static constexpr int BM = 8 * MT;              // tokens: R <= BM
  static constexpr int kThreads = 32 * G + 32;   // and the producer warp
  static constexpr int kSBytes = BN * 128;       // [16 rows][64 bf16], 128-byte swizzle
  static constexpr int kQBytes = G * BN * kSpan;     // [8 experts][16 rows][64 int8]
  static constexpr int kXBytes = G * BM * 128;       // [8 experts][BM rows][64 bf16], swizzled
  static constexpr int kStage = kSBytes + kQBytes + kXBytes;
  static constexpr int kStages = cmin(12, (kMaxSmem - 1024 - 192) / kStage);
  static constexpr int kSmem = 1024 + kStages * kStage + 16 * kStages;
  static_assert(kStage % 1024 == 0, "tiles must stay 1024-byte aligned");
};

template <int MT>
__global__ void __launch_bounds__(Decode<MT>::kThreads, 1)
    int8_experts_decode(const __grid_constant__ Params p) {
  using D = Decode<MT>;
  constexpr int S = D::kStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * D::kStage);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * D::BN, e0 = blockIdx.y * G;
  const int nk = (p.K + kSpan - 1) / kSpan;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G);   // one arrival a compute warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == G) {
    // Producer: a stage is the scale tile, the 8 experts' int8 tiles and
    // their x rows (experts past E and rows past R arrive as zeros).
    if (lane == 0) {
      prefetch_tensor_map(&p.tm_s);
      prefetch_tensor_map(&p.tm_q);
      prefetch_tensor_map(&p.tm_x);
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        uint8_t* st = ring + s * D::kStage;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);   // the first S pass at once
        mbar_arrive_expect_tx(&full[s], D::kStage);
        tma_load_2d(st, &p.tm_s, &full[s], i * kSpan, n0);
        tma_load_3d(st + D::kSBytes, &p.tm_q, &full[s], i * kSpan, n0, e0);
        tma_load_3d(st + D::kSBytes + D::kQBytes, &p.tm_x, &full[s], i * kSpan, 0, e0);
      }
    }
    return;
  }

  // Compute warp: expert e = e0 + warp, the block's 16 rows; a lane holds
  // rows lr and lr + 8.
  const int e = e0 + warp;
  const int lr = lane >> 2, t = lane & 3;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const uint32_t ss = smem_u32(ring + s * D::kStage);
    const uint32_t qs = ss + D::kSBytes + warp * D::BN * kSpan;
    const uint32_t xs = ss + D::kSBytes + D::kQBytes + warp * D::BM * 128;
    // B fragments of the span's four k-steps: words 2i, 2i + 1 of a token
    // row's k 16t .. 16t + 15 (chunks 2t, 2t + 1).
    uint32_t b[MT][8];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 8 + lr;
      const uint4 lo = lds128(xs + r * 128 + (((2 * t) ^ (r & 7)) << 4));
      const uint4 hi = lds128(xs + r * 128 + (((2 * t + 1) ^ (r & 7)) << 4));
      b[mt][0] = lo.x; b[mt][1] = lo.y; b[mt][2] = lo.z; b[mt][3] = lo.w;
      b[mt][4] = hi.x; b[mt][5] = hi.y; b[mt][6] = hi.z; b[mt][7] = hi.w;
    }
    uint32_t a[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 8 * h;
      const uint4 w = lds128(qs + r * kSpan + t * 16);
      // The scales of k 16t .. 16t + 15: chunks 2t, 2t + 1 of row r.
      const uint4 s0 = lds128(ss + r * 128 + (((2 * t) ^ (r & 7)) << 4));
      const uint4 s1 = lds128(ss + r * 128 + (((2 * t + 1) ^ (r & 7)) << 4));
      const uint32_t sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint32_t d[8];
      dequant16(w, sc, d);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        a[k4][h] = d[2 * k4];
        a[k4][2 + h] = d[2 * k4 + 1];
      }
    }
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt], a[k4], b[mt][2 * k4], b[mt][2 * k4 + 1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (e >= p.E) return;   // a warp of a missing expert (E not a multiple of 8)

  // acc[mt][2 h + c] is (row lr + 8 h, token 8 mt + 2t + c).
  __nv_bfloat16* y = p.y + (long long)e * p.R * p.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + lr + 8 * (i >> 1);
      const int m = mt * 8 + 2 * t + (i & 1);
      if (n < p.N && m < p.R) y[(long long)m * p.N + n] = __float2bfloat16_rn(acc[mt][i]);
    }
}

// ---- decode rows, gate and up with SwiGLU: the rows gathered by slot_tok ------

// The fused launch's operands: tensor maps over the tokens x [T, K] (a
// {64, T8} box: every token's 64-k span, T8 = T rounded up to 8), gate's
// and up's int8 [E, F, K] ({64, 8, 8} boxes) and their scales [F, K]
// ({64, 8}); the dispatch's slot_tok and slot_valid [E R] (slot e R + r:
// expert e's row r); h [E, R, F]; the ring's stages and their bytes.
struct SwigluParams {
  CUtensorMap tm_x, tm_qg, tm_qu, tm_sg, tm_su;
  const int* slot_tok;
  const __nv_bfloat16* slot_valid;
  __nv_bfloat16* h;
  int E, R, F, K, T;
  int stages, stage_bytes;
};

// The most tokens the fused launch reads (a TMA box's rows).
constexpr int kSwigluMaxTokens = 256;

// A stage: the [16 x 64] scale tile (gate's 8 rows, then up's), the int8
// tiles ([8 experts][8 rows][64] of gate, then of up), then the T8 token
// rows [T8][64 bf16] (128-byte swizzle), which the consumers read by
// slot_tok; 5 TMA loads a stage, from one producer thread.
constexpr int kSwigluSBytes = 16 * 128;
constexpr int kSwigluQHalf = G * 8 * kSpan;
constexpr int kSwigluXOffset = kSwigluSBytes + 2 * kSwigluQHalf;
static_assert(kSwigluXOffset % 1024 == 0, "the x tile must stay 1024-byte aligned");

template <int MT>
__global__ void __launch_bounds__(32 * G + 32, 2)
    int8_experts_swiglu_decode(const __grid_constant__ SwigluParams p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int S = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * p.stage_bytes);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * 8, e0 = blockIdx.y * G;
  const int nk = (p.K + kSpan - 1) / kSpan;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G);   // one arrival a compute warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == G) {
    // Producer: a stage is both scale boxes, both int8 boxes (experts past
    // E and token rows past T arrive as zeros) and the token rows.
    if (lane == 0) {
      prefetch_tensor_map(&p.tm_sg);
      prefetch_tensor_map(&p.tm_su);
      prefetch_tensor_map(&p.tm_qg);
      prefetch_tensor_map(&p.tm_qu);
      prefetch_tensor_map(&p.tm_x);
      for (int i = 0, s = 0, phase = 1; i < nk; ++i) {
        const int k = i * kSpan;
        uint8_t* st = ring + s * p.stage_bytes;
        mbar_wait(&empty[s], phase);   // the first S pass at once
        mbar_arrive_expect_tx(&full[s], p.stage_bytes);
        tma_load_2d(st, &p.tm_sg, &full[s], k, n0);
        tma_load_2d(st + kSwigluSBytes / 2, &p.tm_su, &full[s], k, n0);
        tma_load_3d(st + kSwigluSBytes, &p.tm_qg, &full[s], k, n0, e0);
        tma_load_3d(st + kSwigluSBytes + kSwigluQHalf, &p.tm_qu, &full[s], k, n0, e0);
        tma_load_2d(st + kSwigluXOffset, &p.tm_x, &full[s], k, 0);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Compute warp: expert e = e0 + warp; a lane holds gate's row lr and up's
  // row lr (A rows lr and lr + 8) of column n0 + lr, and the B fragments of
  // the expert's rows 8 mt + lr: token tok[mt]'s row of the x tile times
  // the slot's slot_valid (bf16 0 or 1: exact, K13's signed zeros and NaNs
  // included). Rows past R read token 0 times 0.
  const int e = e0 + warp;
  const int lr = lane >> 2, t = lane & 3;
  int tok[MT];
  uint32_t valid[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = mt * 8 + lr;
    const bool live = e < p.E && r < p.R;
    tok[mt] = live ? p.slot_tok[e * p.R + r] : 0;
    const uint32_t v =
        live ? *reinterpret_cast<const uint16_t*>(p.slot_valid + e * p.R + r) : 0u;
    valid[mt] = v | (v << 16);
  }
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;

  for (int i = 0, s = 0, phase = 0; i < nk; ++i) {
    mbar_wait(&full[s], phase);
    const uint32_t ss = smem_u32(ring + s * p.stage_bytes);
    const uint32_t qs = ss + kSwigluSBytes + warp * 8 * kSpan;
    const uint32_t xs = ss + kSwigluXOffset;
    uint32_t b[MT][8];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = tok[mt];
      const uint4 lo = lds128(xs + r * 128 + (((2 * t) ^ (r & 7)) << 4));
      const uint4 hi = lds128(xs + r * 128 + (((2 * t + 1) ^ (r & 7)) << 4));
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) b[mt][j] = bf16x2_mul(w[j], valid[mt]);
    }
    uint32_t a[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // h = 0: gate's row lr (scale tile row lr); h = 1: up's (row 8 + lr).
      const int r = lr + 8 * h;
      const uint4 w = lds128(qs + h * kSwigluQHalf + lr * kSpan + t * 16);
      const uint4 s0 = lds128(ss + r * 128 + (((2 * t) ^ (r & 7)) << 4));
      const uint4 s1 = lds128(ss + r * 128 + (((2 * t + 1) ^ (r & 7)) << 4));
      const uint32_t sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint32_t d[8];
      dequant16(w, sc, d);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        a[k4][h] = d[2 * k4];
        a[k4][2 + h] = d[2 * k4 + 1];
      }
    }
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt], a[k4], b[mt][2 * k4], b[mt][2 * k4 + 1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
  if (e >= p.E) return;   // a warp of a missing expert (E not a multiple of 8)

  // acc[mt][c] is gate and acc[mt][2 + c] up of (column n0 + lr, the
  // expert's row 8 mt + 2 t + c).
  uint16_t* h = reinterpret_cast<uint16_t*>(p.h) + (long long)e * p.R * p.F + n0 + lr;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = mt * 8 + 2 * t + c;
      if (m < p.R) h[(long long)m * p.F] = swiglu_of_sums(acc[mt][c], acc[mt][2 + c]);
    }
}

// ---- more rows: TMA + wgmma, the weights as the register A operand -------------

// A block: 128 weight rows (two consumer warpgroups of 64) x BM tokens of
// one expert, and a producer warpgroup.
template <int BM_>
struct Tiled {
  static constexpr int BN = 128, BM = BM_;
  static constexpr int kThreads = 384;
  static constexpr int kXBytes = BM * 128;        // [BM tokens][64 bf16], 128-byte swizzle
  static constexpr int kQBytes = BN * kSpan;      // [128 rows][64 int8], 64-byte swizzle
  static constexpr int kSBytes = BN * 128;        // [128 rows][64 bf16], 128-byte swizzle
  static constexpr int kStage = kXBytes + kQBytes + kSBytes;
  static constexpr int kStages = cmin(8, (kMaxSmem - 1024 - 128) / kStage);
  static constexpr int kSmem = 1024 + kStages * kStage + 16 * kStages;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static_assert(kStage % 1024 == 0, "tiles must stay 1024-byte aligned");
  static_assert(2 * BM * 128 <= kStages * kStage, "the epilogue stages y in the ring");
};

template <int BM>
__global__ void __launch_bounds__(384, 1) int8_experts_tiled(const __grid_constant__ Params p) {
  using T = Tiled<BM>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * T::kStage);
  uint64_t* empty = full + S;
  const bool ef = p.experts_first;
  const int e = ef ? blockIdx.x : blockIdx.z;
  const int m0 = (ef ? blockIdx.y : blockIdx.x) * BM;
  const int n0 = (ef ? blockIdx.z : blockIdx.y) * T::BN;
  const int nk = (p.K + kSpan - 1) / kSpan;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<T::kProducerRegs>();
    if (tid == 0) {
      prefetch_tensor_map(&p.tm_x);
      prefetch_tensor_map(&p.tm_q);
      prefetch_tensor_map(&p.tm_s);
      for (int i = 0; i < nk; ++i) {
        const int s = i % S, k = i * kSpan;
        uint8_t* st = ring + s * T::kStage;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);   // the first S pass at once
        mbar_arrive_expect_tx(&full[s], T::kStage);
        tma_load_3d(st, &p.tm_x, &full[s], k, m0, e);
        tma_load_3d(st + T::kXBytes, &p.tm_q, &full[s], k, n0, e);
        tma_load_2d(st + T::kXBytes + T::kQBytes, &p.tm_s, &full[s], k, n0);
      }
    }
  } else {
    // Consumer warpgroup cw: weight rows n0 + 64 cw .. + 63. A lane's A
    // fragment rows are 16 warp + g + 8 h; for k-step ks its k are 2t, 2t + 1
    // (a[ks][h]) and 2t + 8, 2t + 9 (a[ks][2 + h]), wgmma's natural order:
    // two 4-byte loads of the row's int8 chunk (64-byte swizzle: chunk ks of
    // row r at ks ^ (r / 2 % 4)) and one byte permute give the four weights,
    // two 4-byte loads of the scale row (128-byte swizzle: chunks 2 ks and
    // 2 ks + 1 at ^ r % 8) their scales.
    reg_alloc<T::kConsumerRegs>();
    const int cw = wg - 1, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
    float acc[BM / 2];
#pragma unroll
    for (int j = 0; j < BM / 2; ++j) acc[j] = 0.f;
    // Stage i's int8 words (flipped to q + 128) and scale pairs, loaded
    // while stage i - 1's products run.
    uint32_t f[4][2], sc[4][2][2];
    auto fetch = [&](int i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const uint32_t q8 = smem_u32(ring + s * T::kStage) + T::kXBytes;
      const uint32_t s16 = q8 + T::kQBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * cw + 16 * warp + g + 8 * h;
          const uint32_t chunk = q8 + r * kSpan + ((ks ^ ((r >> 1) & 3)) << 4) + 4 * (t >> 1);
          f[ks][h] = __byte_perm(lds32(chunk), lds32(chunk + 8), sel) ^ 0x80808080u;
          const uint32_t srow = s16 + r * 128 + 4 * t;
          sc[ks][h][0] = lds32(srow + (((2 * ks) ^ (r & 7)) << 4));
          sc[ks][h][1] = lds32(srow + (((2 * ks + 1) ^ (r & 7)) << 4));
        }
    };
    fetch(0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      const uint32_t xb = smem_u32(ring + s * T::kStage);
      uint32_t a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[ks][h] = bf16x2_mul(int8_pair<0, 1>(f[ks][h]), sc[ks][h][0]);
          a[ks][2 + h] = bf16x2_mul(int8_pair<2, 3>(f[ks][h]), sc[ks][h][1]);
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_rs_n<BM>(acc, a[ks], sw128_desc(xb + ks * 32, 16, 1024));
      wgmma_commit();
      if (i + 1 < nk) fetch(i + 1);
      // The A registers are rewritten next stage: wait for the products
      // (the other warpgroup's keep the tensor cores busy meanwhile).
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_operands(acc);
    // Epilogue: y's [BM tokens][64 rows] of this warpgroup, staged in the
    // drained ring by transposing stmatrix stores (the 128-byte swizzle: the
    // 16-byte chunk of rows 8 q .. + 7 of token m at q ^ (m % 8)), then one
    // TMA store, which clips tokens past R and rows past N. acc[4 j + 2 h +
    // v] is (weight row 16 warp + g + 8 h, token 8 j + 2 t + v).
    named_bar_sync(1, 256);              // both warpgroups are done with the ring
    uint8_t* stage = ring + cw * (BM * 128);
    const int q4 = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int j = 0; j < BM / 8; j += 2) {
      const int m = 8 * (j + (q4 >> 1)) + rr, chunk = 2 * warp + (q4 & 1);
      stmatrix_x4_trans(smem_u32(stage) + m * 128 + ((chunk ^ (m & 7)) << 4),
                        flash::pack_bf16(acc[4 * j], acc[4 * j + 1]),
                        flash::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                        flash::pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                        flash::pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
    }
    fence_proxy_async();                 // the TMA store reads what stmatrix wrote
    named_bar_sync(2 + cw, 128);
    if (tid == 0 && n0 + 64 * cw < p.N) {
      tma_store_3d(&p.tm_y, stage, n0 + 64 * cw, m0, e);
      tma_store_commit();
      tma_store_wait_read();             // the block's shared memory outlives the read
    }
  }
}

// ---- host --------------------------------------------------------------------

// Experts run fastest on the tiled grid while x of all of them (2 E R K
// bytes) stays this far below the 50 MB L2; larger x (a prefill group's 84
// MB) takes token tiles fastest.
constexpr long long kExpertsFirstBytes = 16ll << 20;

// Tokens a tiled block for R rows: the fewest padded tokens plus 64 a tile
// for dequantizing its weights once (ties to the larger tile): 17-64 rows
// take 64, 65-128 take 128, 129-256 take 256, 1280 takes 5 x 256.
int tile_tokens(int R) {
  int best = 256;
  long long best_cost = -1;
  for (int bm : {256, 128, 64}) {
    const long long cost = (long long)((R + bm - 1) / bm) * (bm + 64);
    if (best_cost < 0 || cost < best_cost) {
      best = bm;
      best_cost = cost;
    }
  }
  return best;
}

bool encode_x(Params& kp, const void* x, int rows, int experts) {
  return encode_3d(&kp.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, kp.K, kp.R, kp.E,
                   2ull * kp.K, 2ull * kp.K * kp.R, 64, rows, experts,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

bool encode_q(Params& kp, const void* q, int rows, int experts, CUtensorMapSwizzle swizzle) {
  return encode_3d(&kp.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, kp.K, kp.N, kp.E, 1ull * kp.K,
                   1ull * kp.K * kp.N, 64, rows, experts, swizzle);
}

bool encode_s(Params& kp, const void* scale, int rows) {
  return encode_2d(&kp.tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, kp.K, kp.N, 2ull * kp.K,
                   64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MT>
cudaError_t launch_decode(Params& kp, const void* x, const void* q, const void* scale,
                          cudaStream_t stream) {
  using D = Decode<MT>;
  constexpr auto fn = &int8_experts_decode<MT>;
  static bool opted = false;
  cudaError_t err = flash::allow_smem(fn, D::kSmem, opted);
  if (err != cudaSuccess) return err;
  if (!encode_x(kp, x, D::BM, G) || !encode_q(kp, q, D::BN, G, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_s(kp, scale, D::BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((kp.N + D::BN - 1) / D::BN, (kp.E + G - 1) / G);
  fn<<<grid, D::kThreads, D::kSmem, stream>>>(kp);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_tiled(Params& kp, const void* x, const void* q, const void* scale, void* y,
                         cudaStream_t stream) {
  using T = Tiled<BM>;
  constexpr auto fn = &int8_experts_tiled<BM>;
  static bool opted = false;
  cudaError_t err = flash::allow_smem(fn, T::kSmem, opted);
  if (err != cudaSuccess) return err;
  if (!encode_x(kp, x, BM, 1) || !encode_q(kp, q, T::BN, 1, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_s(kp, scale, T::BN) ||
      !encode_3d(&kp.tm_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, kp.N, kp.R, kp.E, 2ull * kp.N,
                 2ull * kp.N * kp.R, 64, BM, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const unsigned rows = (kp.N + T::BN - 1) / T::BN, tokens = (kp.R + BM - 1) / BM;
  const dim3 grid = kp.experts_first ? dim3(kp.E, tokens, rows) : dim3(tokens, rows, kp.E);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(kp);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_swiglu(SwigluParams& kp, const void* x, const void* gate_q,
                          const void* gate_s, const void* up_q, const void* up_s,
                          cudaStream_t stream) {
  constexpr auto fn = &int8_experts_swiglu_decode<MT>;
  static bool opted = false;
  cudaError_t err = flash::allow_smem(fn, kMaxSmem, opted);
  if (err != cudaSuccess) return err;
  const int E = kp.E, F = kp.F, K = kp.K, T8 = (kp.T + 7) / 8 * 8;
  // As many stages as fit in half an SM's shared memory (two blocks an
  // SM, each with 1 KB the runtime reserves), up to 12: 10 at T = 8.
  kp.stage_bytes = kSwigluXOffset + T8 * 128;
  kp.stages = cmin(12, (kMaxSmem / 2 - 2048) / (kp.stage_bytes + 16));
  auto q_map = [&](CUtensorMap* m, const void* q) {
    return encode_3d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, F, E, 1ull * K, 1ull * K * F, 64, 8,
                     G, CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  auto s_map = [&](CUtensorMap* m, const void* s) {
    return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, K, F, 2ull * K, 64, 8,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  };
  if (!encode_2d(&kp.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, kp.T, 2ull * K, 64, T8,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !q_map(&kp.tm_qg, gate_q) || !q_map(&kp.tm_qu, up_q) || !s_map(&kp.tm_sg, gate_s) ||
      !s_map(&kp.tm_su, up_s)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(F / 8, (E + G - 1) / G);
  const int smem = 1024 + kp.stages * (kp.stage_bytes + 16);
  fn<<<grid, 32 * G + 32, smem, stream>>>(kp);
  return cudaGetLastError();
}

}  // namespace

// y[e] = x[e] . dequant(q[e], scale)^T for every expert e (see the header):
// x bf16 [E, R, K], q int8 [E, N, K], scale bf16 [N, K], y bf16 [E, R, N],
// all contiguous and 16-byte aligned; N and K multiples of 16, E and R >= 1.
// Overrides of the tiled kernel's plan (R > 16), each 0 for the plan's own
// choice: ``bm`` (64, 128 or 256 tokens a tile; tile_tokens) and
// ``order`` (1: token tiles fastest, 2: experts fastest; by x's size).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_int8_experts_config(const void* x, const void* q, const void* scale, void* y,
                                         int E, int R, int N, int K, int bm, int order,
                                         void* stream) {
  if (E < 1 || R < 1 || N < 16 || N % 16 || K < 16 || K % 16) return cudaErrorInvalidValue;
  if (bm == 0) bm = tile_tokens(R);
  if (order == 0) order = 2ll * E * R * K <= kExpertsFirstBytes ? 2 : 1;
  if ((bm != 64 && bm != 128 && bm != 256) || (order != 1 && order != 2)) {
    return cudaErrorInvalidValue;
  }
  Params p = {};
  p.y = static_cast<__nv_bfloat16*>(y);
  p.E = E;
  p.R = R;
  p.N = N;
  p.K = K;
  p.experts_first = order == 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R <= 8) {
    err = launch_decode<1>(p, x, q, scale, st);
  } else if (R <= 16) {
    err = launch_decode<2>(p, x, q, scale, st);
  } else if (bm == 64) {
    err = launch_tiled<64>(p, x, q, scale, y, st);
  } else if (bm == 128) {
    err = launch_tiled<128>(p, x, q, scale, y, st);
  } else {
    err = launch_tiled<256>(p, x, q, scale, y, st);
  }
  return static_cast<int>(err);
}

// The same with the plan's choices (see kftpu_int8_experts_config).
extern "C" int kftpu_int8_experts(const void* x, const void* q, const void* scale, void* y, int E,
                                  int R, int N, int K, void* stream) {
  return kftpu_int8_experts_config(x, q, scale, y, E, R, N, K, 0, 0, stream);
}

// h[e, r] = silu(g) * u of expert e's row r, g = x_e . dequant(gate_q[e],
// gate_s)^T and u the same of up, x_e = x[slot_tok[e R + r]] *
// slot_valid[e R + r] (see the header): x bf16 [T, K], slot_tok int32 [E R],
// slot_valid bf16 [E R], gate_q and up_q int8 [E, F, K], gate_s and up_s
// bf16 [F, K], h bf16 [E, R, F], all contiguous and 16-byte aligned;
// bitwise the gather (K13), this file's product of gate and of up, then
// K9. The wrapper checks that the operands have these shapes. Refuses
// (cudaErrorInvalidValue) R outside 1..16, T outside 1..256, F or K not a
// multiple of 16, E below 1. Returns the CUDA error code of the launch (0
// = launched).
extern "C" int kftpu_int8_experts_swiglu(const void* x, const int* slot_tok,
                                         const void* slot_valid, const void* gate_q,
                                         const void* gate_s, const void* up_q, const void* up_s,
                                         void* h, int T, int E, int R, int F, int K,
                                         void* stream) {
  if (T < 1 || T > kSwigluMaxTokens || E < 1 || R < 1 || R > 16 || F < 16 || F % 16 ||
      K < 16 || K % 16) {
    return cudaErrorInvalidValue;
  }
  SwigluParams p = {};
  p.slot_tok = slot_tok;
  p.slot_valid = static_cast<const __nv_bfloat16*>(slot_valid);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.E = E;
  p.R = R;
  p.F = F;
  p.K = K;
  p.T = T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = R <= 8 ? launch_swiglu<1>(p, x, gate_q, gate_s, up_q, up_s, st)
                                 : launch_swiglu<2>(p, x, gate_q, gate_s, up_q, up_s, st);
  return static_cast<int>(err);
}
