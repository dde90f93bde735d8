// Flash-attention backward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see kubeflow_tpu_torch/ops/flash_attention.py.
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_bwd_kernel (the Pallas TPU
// backward kernel). Same function: from q, k, v, the forward's lse and the
// output cotangent do, it recomputes p = exp(s - lse) blockwise and forms
//   dv = p^T do,  dp = do v^T,  ds = p (dp - delta),
//   dk = ds^T q * scale,  dq = ds k * scale,
// with GQA (kv head = h / G; dk and dv sum over the G query heads of their
// kv head). delta = rowsum(do * o) - dlse [B, H, Sq] f32 is computed by the
// wrapper, as the JAX wrapper computes it outside its kernel. A fully
// masked row (lse = -1e30) gives p = 0 through the same
// max(lse * log2e, -1e29) clamp as the TPU kernel, masked scores being
// -inf before the exponent, so its grads are exactly 0. The causal offset
// (q position of row 0 minus kv position of col 0) is read from a device
// int32 pointer, as in the forward.
//
// Layout: q, do, dq [B, Sq, H, D] and k, v, dk, dv [B, Skv, Hkv, D] are read
// and written through their strides (last dim contiguous, strides a
// multiple of 8 elements); lse and delta are contiguous.
//
// The TPU kernel is one fused pass that keeps the whole query group's dq in
// VMEM across a sequential grid. CUDA blocks run in any order with no state
// between them, so this file splits the work into two deterministic
// kernels and needs no atomics: every element of dq, dk and dv is written
// by exactly one block, and two calls give bitwise-equal grads.
//
// Bound on this card: the function needs five products over the live
// (q, kv) pairs, 10 B H D x live FLOPs; the split recomputes s and p in
// both kernels and dp in both, seven products, 14 B H D x live. At the
// training shape (B=12, S=2048, H=16/8, D=128, causal) that is 7.22e11
// FLOP = 0.730 ms at 989 TFLOP/s against 0.521 ms for the five, and about
// 850 FLOP per byte moved: the tensor cores bound it. So every product runs
// on wgmma, the only path to their full rate, fed by TMA so that no thread
// spends registers or issue slots on loads; the S x S matrices never leave
// registers. The skeleton is the forward's (flash_attention_fwd.cu): a
// producer warpgroup (setmaxnreg 24) whose one thread issues every TMA
// load into a 2-stage ring on full/empty mbarriers, and consumer
// warpgroups of 64 rows each (setmaxnreg 240; 232 where two blocks share an
// SM).
//
// (a) dk/dv: one block per (128-row kv tile, kv head, batch). The blocks
//     walk windows of 8 (kv head, batch) groups with the kv tile slowest:
//     a window's low kv tiles (the heaviest under the causal mask) start
//     first and its last blocks are light, while the groups whose Q and dO
//     the blocks share through L2 run together. K and V are loaded once.
//     The ring streams 64-row Q and dO tiles over the G query heads of the
//     kv head and, for each, the q tiles the causal bound lets through: one
//     flat tile counter for the ring's phase, the same count on both sides.
//     Each stage also holds the tile's lse2 = max(lse log2e, -1e29) and
//     delta, written by the producer's first warp with plain loads (an
//     [B, H, Sq] f32 row breaks TMA's 16-byte stride rule when Sq % 4 != 0),
//     lse2 = +1e30 past Sq so that those rows' p is 0. Each consumer owns
//     64 kv rows and works in the transposed domain, so p^T and ds^T are
//     accumulator rows that re-pack into wgmma's register A operand:
//       s^T = K Q^T, dp^T = V dO^T   (wgmma SS, both K-major),
//       p^T = exp2(s^T scale log2e - lse2), ds^T = p^T (dp^T - delta),
//       dV += p^T dO, dK += ds^T Q   (wgmma RS, dO and Q MN-major),
//     each product its own group, awaited only where its result is needed:
//     p^T is computed while dp^T runs and ds^T while dV does. Registers
//     per consumer thread at D = 128: dK and dV 64 f32 each, s^T and dp^T
//     32 each, p^T and ds^T 16 b32 each, under setmaxnreg 240 with no
//     spills; so K and V stay in shared memory (in registers they would
//     need 64 more and ptxas spills). Only tiles the causal frontier cuts
//     are masked; kv rows past Skv are computed and never stored. dK scale
//     and dV go out in bf16 through the consumer's own rows of the K and V
//     tiles and a TMA store, which clips rows >= Skv; a block with no live
//     q tile stores zeros.
// (b) dq: one block per (64-row q tile, head, batch), heavy q tiles first,
//     with one consumer warpgroup and two blocks per SM (as fast as one
//     block of two consumers over 128 rows at the training shape, faster
//     at shorter ones: PERF.md). Q, dO, lse2 and delta stay put, Q and dO
//     as register A fragments (64 b32 a thread), so that s and dp read only
//     K and V from shared memory; 64-row K and V tiles stream through the
//     ring over the live kv tiles (the forward's causal frontier):
//       s = Q K^T, dp = dO V^T (RS, K and V K-major), p, ds = p (dp - delta),
//       dQ += ds K (RS, K MN-major),
//     masked where the diagonal or the ragged kv edge cuts the tile; dQ
//     scale goes out through the Q tile by TMA.
//
// f32: plain FMA kernels, one warp per kv row (dk/dv) and per q row (dq);
// a correctness path (the model trains bf16).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr float kPosBig = 1e30f;    // lse2 of q rows past the edge: p = 0
constexpr int kProducerRegs = 24;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* offset;
  int B, H, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  float scale_log2;
  int causal;
};

__device__ __forceinline__ long long stat_index(const Params& p, int b, int h, int row) {
  return (static_cast<long long>(b) * p.H + h) * p.Sq + row;
}

// The bf16 kernels' arguments: tensor maps (loads and stores), passed by
// value in parameter space, and what the maps do not carry.
struct HopperParams {
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_out0, tm_out1;   // out: (dk, dv) or (dq, -)
  const float* lse;
  const float* delta;
  const int* offset;
  int B, H, Hkv, Sq, Skv;
  float scale;
  float scale_log2;
  int causal;
};

// lse2 and delta of q row ``row`` of head h: lse2 = +1e30 and delta = 0
// past Sq, so that p = 0 there.
__device__ __forceinline__ void load_stats(const HopperParams& p, int b, int h, int row,
                                           float& lse2, float& delta) {
  const bool ok = row < p.Sq;
  const long long idx = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
  lse2 = ok ? fmaxf(p.lse[idx] * kLog2e, kMClamp) : kPosBig;
  delta = ok ? p.delta[idx] : 0.f;
}

// Stages this thread's rows (r0, r0 + 8) of a 64 x D f32 accumulator,
// times ``mul``, as bf16 into ``box0``: the 64-row sub-tile of a tile whose
// 64-column boxes lie ``box_stride`` bytes apart, in the 128-byte swizzle
// of a TMA box (the 16-byte chunk ch of row r sits at chunk ch ^ (r % 8);
// r % 8 == g).
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* box0, int box_stride, int r0, int g,
                                           int t4, const float (&acc)[D / 2], float mul) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    unsigned char* box = box0 + (jj >> 3) * box_stride;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      *reinterpret_cast<uint32_t*>(box + r * 128 + (((jj & 7) ^ g) << 4) + 4 * t4) =
          pack_bf16(acc[4 * jj + 2 * i] * mul, acc[4 * jj + 2 * i + 1] * mul);
    }
  }
}

// The m16n8k16 A fragments of a 64 x N accumulator (the wgmma accumulator
// gives each warp mma.sync's m16n8 pattern), rounded to bf16: the register
// A operand of a product over N.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
  }
}

// The m16n8k16 A fragments of this thread's rows (r0, r0 + 8) of a 64-row
// K-major bf16 tile over D, read from its 128-byte-swizzled boxes
// ``box_stride`` bytes apart (row r's 16-byte chunk ch sits at ch ^ (r % 8);
// r % 8 == g): the register A operand of a product over D.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const unsigned char* tile,
                                       int box_stride, int r0, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned char* box = tile + (kk >> 2) * box_stride + 4 * t4;
    const int lo = ((2 * (kk & 3)) ^ g) << 4;         // columns 16 kk + 2 t4, + 1
    const int hi = ((2 * (kk & 3) + 1) ^ g) << 4;     // and 8 on
    a[kk][0] = *reinterpret_cast<const uint32_t*>(box + r0 * 128 + lo);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(box + (r0 + 8) * 128 + lo);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(box + r0 * 128 + hi);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(box + (r0 + 8) * 128 + hi);
  }
}

// acc (64 x 64) = A (registers, 64 x D) B^T (64 rows at b_addr, K-major
// bf16 in 64-column boxes ``b_box`` bytes apart).
template <int D>
__device__ __forceinline__ void product_rs_k(float (&acc)[32], const uint32_t (&a)[D / 16][4],
                                             uint32_t b_addr, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = sw128_desc(b_addr + (kk >> 2) * b_box + (kk & 3) * 32, 16, 1024);
    wgmma_rs_m64n64k16(acc, a[kk], db, kk > 0);
  }
}

// acc (64 x 64) = A (64 rows at a_addr) B^T (64 rows at b_addr) over D,
// both K-major bf16 tiles of 64-column boxes ``a_box`` / ``b_box`` bytes
// apart.
template <int D>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a_addr, int a_box,
                                           uint32_t b_addr, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;      // 16 bf16 within a 128-byte row
    const uint64_t da = sw128_desc(a_addr + (kk >> 2) * a_box + col, 16, 1024);
    const uint64_t db = sw128_desc(b_addr + (kk >> 2) * b_box + col, 16, 1024);
    wgmma_ss_m64n64k16(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A (registers, 64 x K) B (K rows x D at b_addr, MN-major:
// D contiguous, 64-column boxes ``b_box`` bytes apart).
template <int D, int K>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b_addr, int b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    // 16 rows = two 8-row groups of 1024 bytes; the next 64 columns are
    // the next box.
    const uint64_t db = sw128_desc(b_addr + kk * 16 * 128, b_box, 1024);
    if constexpr (D == 128) {
      wgmma_rs_m64n128k16_mn(acc, a[kk], db);
    } else {
      wgmma_rs_m64n64k16_mn(acc, a[kk], db);
    }
  }
}

// Block ``block`` of a 1-D grid over n_groups x n_tiles blocks, walked in
// windows of kWindow groups: a window takes its tile index slowest and its
// groups fastest, so the heaviest tiles (index 0) of the window start
// first and the last blocks to start are light ones, while the window's
// groups, whose operands the blocks share through L2, run together (8
// groups x 16 tiles: about one wave of blocks at the training shape).
__device__ __forceinline__ void window_order(int block, int n_tiles, int n_groups, int& tile,
                                             int& group) {
  constexpr int kWindow = 8;
  const int w = block / (kWindow * n_tiles);
  const int size = min(kWindow, n_groups - w * kWindow);
  const int r = block - w * kWindow * n_tiles;
  tile = r / size;
  group = w * kWindow + r % size;
}

// ---------------------------------------------------------------- bf16 (a)

template <int D_>
struct DkDvTiles {
  static constexpr int D = D_;
  static constexpr int kBlockN = 128;   // kv rows per block: two consumers of 64
  static constexpr int kBlockM = 64;    // q rows per ring tile
  static constexpr int kConsumers = 2;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerRegs = 240;   // 128 x 24 + 256 x 240 <= 64 K
  static constexpr int kBoxes = D / 64;
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  // A stage: the q tile, the do tile, lse2 and delta (64 f32 each), padded
  // to keep the next stage's tiles on a 1024-byte boundary.
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  // 1024 bytes of slack to align the tiles, k, v, the ring, 5 barriers.
  static constexpr int kSmem = 1024 + 2 * kKVBytes + kStages * kStageBytes + 64;
  static constexpr int kFullArrivals = 1 + 32;   // the loads' arrive + one per stats lane
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ HopperParams p) {
  constexpr int D = T::D;
  constexpr int kBlockM = T::kBlockM;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + T::kKVBytes;
  unsigned char* sRing = sV + T::kKVBytes;   // kStages x (q, do, lse2, delta)
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sRing + kStages * T::kStageBytes);
  uint64_t* full = full_kv + 1;                // [kStages]
  uint64_t* empty = full + kStages;            // [kStages]

  int kv_tile, group;
  window_order(blockIdx.x, (p.Skv + kBlockN - 1) / kBlockN, p.Hkv * p.B, kv_tile, group);
  const int n0 = kv_tile * kBlockN;   // low kv tiles see the most q tiles
  const int hk = group % p.Hkv;
  const int b = group / p.Hkv;
  const int G = p.H / p.Hkv;
  const int off = p.causal ? *p.offset : 0;
  // Causal: q row i sees kv row j iff i + off >= j, so no q row before
  // n0 - off reaches this kv tile. Both roles walk the same tiles: for each
  // query head of the group, q tiles t_begin .. n_m - 1.
  const int n_m = (p.Sq + kBlockM - 1) / kBlockM;
  const int t_begin = p.causal ? min(n_m, max(0, n0 - off) / kBlockM) : 0;
  const int per_head = n_m - t_begin;
  const int n_tiles = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], T::kFullArrivals);
      mbar_init(&empty[s], T::kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: thread 0 issues every TMA load, the first warp writes the
    // statistics of each tile.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensor_map(&p.tm_q);
        prefetch_tensor_map(&p.tm_do);
        mbar_arrive_expect_tx(full_kv, 2 * T::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load_4d(sK + bx * kBlockN * 128, &p.tm_k, full_kv, bx * 64, n0, hk, b);
          tma_load_4d(sV + bx * kBlockN * 128, &p.tm_v, full_kv, bx * 64, n0, hk, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int h = hk * G + i / per_head;
        const int m0 = (t_begin + i % per_head) * kBlockM;
        const int s = i % kStages;
        unsigned char* stage = sRing + s * T::kStageBytes;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);   // the first kStages pass at once
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * T::kQBytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx) {
            tma_load_4d(stage + bx * kBlockM * 128, &p.tm_q, &full[s], bx * 64, m0, h, b);
            tma_load_4d(stage + T::kQBytes + bx * kBlockM * 128, &p.tm_do, &full[s], bx * 64,
                        m0, h, b);
          }
        }
        float* lse2 = reinterpret_cast<float*>(stage + 2 * T::kQBytes);
#pragma unroll
        for (int r = lane; r < kBlockM; r += 32) {
          load_stats(p, b, h, m0 + r, lse2[r], lse2[kBlockM + r]);
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumer warpgroup c: kv rows n0 + 64 c .. n0 + 64 c + 63.
    reg_alloc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2;            // row within the 8-row half of a warp's 16
    const int t4 = tid & 3;                   // column pair within the quad
    const int r0 = (tid >> 5) * 16 + g;       // this thread's rows: r0 and r0 + 8
    const int kv_row0 = n0 + 64 * c + r0;     // absolute kv row of r0
    unsigned char* sKc = sK + c * 64 * 128;
    unsigned char* sVc = sV + c * 64 * 128;
    const uint32_t k_addr = smem_u32(sKc);
    const uint32_t v_addr = smem_u32(sVc);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[kBlockM / 2], dpt[kBlockM / 2];   // s^T (then p^T) and dp^T (then ds^T)
    uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];

    mbar_wait(full_kv, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int m0 = (t_begin + i % per_head) * kBlockM;
      const int s = i % kStages;
      unsigned char* stage = sRing + s * T::kStageBytes;
      const uint32_t q_addr = smem_u32(stage);
      const uint32_t do_addr = q_addr + T::kQBytes;
      const float* lse2 = reinterpret_cast<const float*>(stage + 2 * T::kQBytes);
      const float* delta = lse2 + kBlockM;
      // Four products in four groups, each awaited only where its result is
      // needed: p^T is computed while dp^T runs, ds^T while dV does.
      mbar_wait(&full[s], (i / kStages) & 1);
      wgmma_fence();
      product_ss<D>(st, k_addr, kBlockN * 128, q_addr, kBlockM * 128);
      wgmma_commit();
      product_ss<D>(dpt, v_addr, kBlockN * 128, do_addr, kBlockM * 128);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(st);

      // Element e of s^T: kv row r0 (+ 8 for e & 2), q column
      // 8 (e >> 2) + 2 t4 + (e & 1). Only tiles the diagonal cuts are
      // masked; masked scores are -inf before the exponent, so p is 0.
      const bool need_mask = p.causal && (m0 + off < n0 + kBlockN - 1);
#pragma unroll
      for (int e = 0; e < kBlockM / 2; ++e) {
        const int qc = (e >> 2) * 8 + t4 * 2 + (e & 1);
        float x = st[e];
        if (need_mask && m0 + qc + off < kv_row0 + ((e >> 1) & 1) * 8) x = -INFINITY;
        st[e] = fast_exp2(fmaf(x, p.scale_log2, -lse2[qc]));
      }
      pack_a<kBlockM>(pa, st);
      wgmma_fence();
      product_rs<D, kBlockM>(dv, pa, do_addr, kBlockM * 128);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(dpt);
#pragma unroll
      for (int e = 0; e < kBlockM / 2; ++e) {
        const int qc = (e >> 2) * 8 + t4 * 2 + (e & 1);
        dpt[e] = st[e] * (dpt[e] - delta[qc]);
      }
      pack_a<kBlockM>(da, dpt);
      wgmma_fence();
      product_rs<D, kBlockM>(dk, da, q_addr, kBlockM * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      mbar_arrive(&empty[s]);
    }

    // dK scale and dV in bf16 over this consumer's rows of the K and V
    // tiles, which no product reads any more (and which TMA filled: the
    // wait on full_kv above runs for a block with no q tile too); one
    // thread stores them, rows >= Skv clipped.
    stage_rows<D>(sKc, kBlockN * 128, r0, g, t4, dk, p.scale);
    stage_rows<D>(sVc, kBlockN * 128, r0, g, t4, dv, 1.f);
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < T::kBoxes; ++bx) {
        tma_store_4d(&p.tm_out0, sKc + bx * kBlockN * 128, bx * 64, n0 + 64 * c, hk, b);
        tma_store_4d(&p.tm_out1, sVc + bx * kBlockN * 128, bx * 64, n0 + 64 * c, hk, b);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ---------------------------------------------------------------- bf16 (b)

template <int D_>
struct DqTiles {
  static constexpr int D = D_;
  static constexpr int kBlockM = 64;       // q rows per block: one consumer warpgroup
  static constexpr int kBlockN = 64;       // kv rows per ring tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 256;     // the producer and the consumer warpgroup
  static constexpr int kMinBlocks = 2;     // 2 x 128 x (24 + 232) = 64 K registers
  static constexpr int kConsumerRegs = 232;
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  // 1024 bytes of slack to align the tiles, q, do, the k and v rings and
  // 1 + 2 kStages barriers.
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 64;
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    flash_bwd_dq_bf16(const __grid_constant__ HopperParams p) {
  constexpr int D = T::D;
  constexpr int kBlockM = T::kBlockM;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sDo = sQ + T::kQBytes;
  unsigned char* sK = sDo + T::kQBytes;               // kStages k tiles
  unsigned char* sV = sK + kStages * T::kKVBytes;      // kStages v tiles
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kStages * T::kKVBytes);
  uint64_t* full = full_q + 1;                          // [kStages]
  uint64_t* empty = full + kStages;                     // [kStages]

  // Last q tiles first: under the causal mask they carry the most kv tiles.
  // (The dk/dv kernel's windowed order measured slower here: PERF.md.)
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.causal ? *p.offset : 0;
  // Causal skip: kv columns past the tile's last live q position are dead.
  int n_end = p.Skv;
  if (p.causal) n_end = min(n_end, min(m0 + kBlockM, p.Sq) + off);
  const int n_tiles = n_end > 0 ? (n_end + kBlockN - 1) / kBlockN : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread issues every load.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&p.tm_k);
      prefetch_tensor_map(&p.tm_v);
      mbar_arrive_expect_tx(full_q, 2 * T::kQBytes);
#pragma unroll
      for (int bx = 0; bx < T::kBoxes; ++bx) {
        tma_load_4d(sQ + bx * kBlockM * 128, &p.tm_q, full_q, bx * 64, m0, h, b);
        tma_load_4d(sDo + bx * kBlockM * 128, &p.tm_do, full_q, bx * 64, m0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load_4d(sK + s * T::kKVBytes + bx * kBlockN * 128, &p.tm_k, &full[s], bx * 64,
                      t * kBlockN, hk, b);
          tma_load_4d(sV + s * T::kKVBytes + bx * kBlockN * 128, &p.tm_v, &full[s], bx * 64,
                      t * kBlockN, hk, b);
        }
      }
    }
  } else {
    // Consumer: q rows m0 .. m0 + 63.
    reg_alloc<T::kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2;
    const int t4 = tid & 3;
    const int r0 = (tid >> 5) * 16 + g;       // this thread's rows: r0 and r0 + 8

    float lse2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) load_stats(p, b, h, m0 + r0 + 8 * i, lse2[i], delta[i]);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[kBlockN / 2], dp[kBlockN / 2];   // s, and dp (then ds)
    uint32_t da[kBlockN / 16][4];

    // Q and dO stay put: they move once into registers, the A operands of
    // s and dp, so that those products read only K and V from shared
    // memory.
    uint32_t qa[D / 16][4], doa[D / 16][4];
    mbar_wait(full_q, 0);
    load_a<D>(qa, sQ, kBlockM * 128, r0, g, t4);
    load_a<D>(doa, sDo, kBlockM * 128, r0, g, t4);
    for (int t = 0; t < n_tiles; ++t) {
      const int n0 = t * kBlockN;
      const int s = t % kStages;
      const uint32_t k_addr = smem_u32(sK + s * T::kKVBytes);
      const uint32_t v_addr = smem_u32(sV + s * T::kKVBytes);
      mbar_wait(&full[s], (t / kStages) & 1);
      wgmma_fence();
      product_rs_k<D>(sc, qa, k_addr, kBlockN * 128);
      product_rs_k<D>(dp, doa, v_addr, kBlockN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);

      // Only tiles cut by the ragged kv edge or by the diagonal are masked.
      const bool need_mask =
          (n0 + kBlockN > p.Skv) || (p.causal && (m0 + off < n0 + kBlockN - 1));
#pragma unroll
      for (int e = 0; e < kBlockN / 2; ++e) {
        const int row = (e >> 1) & 1;
        float x = sc[e];
        if (need_mask) {
          const int col = n0 + (e >> 2) * 8 + t4 * 2 + (e & 1);
          const int qp = m0 + r0 + row * 8 + off;
          if (col >= p.Skv || (p.causal && qp < col)) x = -INFINITY;
        }
        const float pe = fast_exp2(fmaf(x, p.scale_log2, -lse2[row]));
        dp[e] = pe * (dp[e] - delta[row]);
      }
      pack_a<kBlockN>(da, dp);
      wgmma_fence();
      product_rs<D, kBlockN>(dq, da, k_addr, kBlockN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq);
      mbar_arrive(&empty[s]);
    }

    // dQ scale in bf16 over the Q tile, once every thread has its Q
    // fragments; one thread stores, rows >= Sq clipped.
    named_bar_sync(1, 128);
    stage_rows<D>(sQ, kBlockM * 128, r0, g, t4, dq, p.scale);
    fence_proxy_async();
    named_bar_sync(1, 128);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < T::kBoxes; ++bx) {
        tma_store_4d(&p.tm_out0, sQ + bx * kBlockM * 128, bx * 64, m0, h, b);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ---------------------------------------------------------------- f32

// dk/dv, one warp per kv row: loops over the G query heads and the live q
// rows; each lane holds D / 32 elements of the row.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32(Params p) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= p.Skv) return;   // warp-uniform
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int off = p.causal ? *p.offset : 0;
  const float* kr = static_cast<const float*>(p.k) + b * p.k_sb + j * p.k_ss + hk * p.k_sh +
                    lane * kPer;
  const float* vr = static_cast<const float*>(p.v) + b * p.v_sb + j * p.v_ss + hk * p.v_sh +
                    lane * kPer;
  float k[kPer], v[kPer], dk[kPer], dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    k[i] = kr[i];
    v[i] = vr[i];
    dk[i] = dv[i] = 0.f;
  }
  const int i_begin = p.causal ? max(0, j - off) : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qh = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + lane * kPer;
    const float* doh =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh + lane * kPer;
    for (int i = i_begin; i < p.Sq; ++i) {
      const float* qi = qh + i * p.q_ss;
      const float* doi = doh + i * p.do_ss;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        s = fmaf(qi[e], k[e], s);
        dp = fmaf(doi[e], v[e], dp);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, w);
        dp += __shfl_xor_sync(0xffffffffu, dp, w);
      }
      const long long idx = stat_index(p, b, h, i);
      const float lse2 = fmaxf(p.lse[idx] * kLog2e, kMClamp);
      const float pj = exp2f(s * p.scale_log2 - lse2);
      const float ds = pj * (dp - p.delta[idx]);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        dv[e] = fmaf(pj, doi[e], dv[e]);
        dk[e] = fmaf(ds, qi[e], dk[e]);
      }
    }
  }
  float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb + j * p.dk_ss + hk * p.dk_sh + lane * kPer;
  float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb + j * p.dv_ss + hk * p.dv_sh + lane * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    dkr[e] = dk[e] * p.scale;
    dvr[e] = dv[e];
  }
}

// dq, one warp per q row over its live kv rows.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(Params p) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;   // heavy rows first
  if (i >= p.Sq) return;   // warp-uniform
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.causal ? *p.offset : 0;
  const float* qi = static_cast<const float*>(p.q) + b * p.q_sb + i * p.q_ss + h * p.q_sh +
                    lane * kPer;
  const float* doi = static_cast<const float*>(p.dout) + b * p.do_sb + i * p.do_ss +
                     h * p.do_sh + lane * kPer;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + lane * kPer;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + lane * kPer;
  float q[kPer], dout[kPer], dq[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    q[e] = qi[e];
    dout[e] = doi[e];
    dq[e] = 0.f;
  }
  const long long idx = stat_index(p, b, h, i);
  const float lse2 = fmaxf(p.lse[idx] * kLog2e, kMClamp);
  const float delta = p.delta[idx];
  int n_end = p.Skv;
  if (p.causal) n_end = min(n_end, i + off + 1);
  for (int j = 0; j < n_end; ++j) {
    const float* kj = kh + j * p.k_ss;
    const float* vj = vh + j * p.v_ss;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      s = fmaf(q[e], kj[e], s);
      dp = fmaf(dout[e], vj[e], dp);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, w);
      dp += __shfl_xor_sync(0xffffffffu, dp, w);
    }
    const float ds = exp2f(s * p.scale_log2 - lse2) * (dp - delta);
#pragma unroll
    for (int e = 0; e < kPer; ++e) dq[e] = fmaf(ds, kj[e], dq[e]);
  }
  float* dqr = static_cast<float*>(p.dq) + b * p.dq_sb + i * p.dq_ss + h * p.dq_sh + lane * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) dqr[e] = dq[e] * p.scale;
}

// ---------------------------------------------------------------- launch

// The fields of the bf16 kernels' parameters that the maps do not carry.
HopperParams hopper_params(const Params& a) {
  HopperParams p;
  p.lse = a.lse;
  p.delta = a.delta;
  p.offset = a.offset;
  p.B = a.B;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Skv = a.Skv;
  p.scale = a.scale;
  p.scale_log2 = a.scale_log2;
  p.causal = a.causal;
  return p;
}

template <class T>
cudaError_t launch_dkdv_bf16(const Params& a, cudaStream_t stream) {
  constexpr int D = T::D;
  static bool smem_set = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_bf16<T>, T::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  HopperParams p = hopper_params(a);
  const bool maps =
      encode_bshd_bf16(&p.tm_q, a.q, a.B, a.Sq, a.H, D, a.q_ss, a.q_sh, a.q_sb, T::kBlockM) &&
      encode_bshd_bf16(&p.tm_do, a.dout, a.B, a.Sq, a.H, D, a.do_ss, a.do_sh, a.do_sb,
                       T::kBlockM) &&
      encode_bshd_bf16(&p.tm_k, a.k, a.B, a.Skv, a.Hkv, D, a.k_ss, a.k_sh, a.k_sb, T::kBlockN) &&
      encode_bshd_bf16(&p.tm_v, a.v, a.B, a.Skv, a.Hkv, D, a.v_ss, a.v_sh, a.v_sb, T::kBlockN) &&
      encode_bshd_bf16(&p.tm_out0, a.dk, a.B, a.Skv, a.Hkv, D, a.dk_ss, a.dk_sh, a.dk_sb, 64) &&
      encode_bshd_bf16(&p.tm_out1, a.dv, a.B, a.Skv, a.Hkv, D, a.dv_ss, a.dv_sh, a.dv_sb, 64);
  if (!maps) return cudaErrorInvalidValue;
  const int grid = (a.Skv + T::kBlockN - 1) / T::kBlockN * a.Hkv * a.B;
  flash_bwd_dkdv_bf16<T><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_dq_bf16(const Params& a, cudaStream_t stream) {
  constexpr int D = T::D;
  static bool smem_set = false;
  cudaError_t err = allow_smem(flash_bwd_dq_bf16<T>, T::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  HopperParams p = hopper_params(a);
  const bool maps =
      encode_bshd_bf16(&p.tm_q, a.q, a.B, a.Sq, a.H, D, a.q_ss, a.q_sh, a.q_sb, T::kBlockM) &&
      encode_bshd_bf16(&p.tm_do, a.dout, a.B, a.Sq, a.H, D, a.do_ss, a.do_sh, a.do_sb,
                       T::kBlockM) &&
      encode_bshd_bf16(&p.tm_k, a.k, a.B, a.Skv, a.Hkv, D, a.k_ss, a.k_sh, a.k_sb, T::kBlockN) &&
      encode_bshd_bf16(&p.tm_v, a.v, a.B, a.Skv, a.Hkv, D, a.v_ss, a.v_sh, a.v_sb, T::kBlockN) &&
      encode_bshd_bf16(&p.tm_out0, a.dq, a.B, a.Sq, a.H, D, a.dq_ss, a.dq_sh, a.dq_sb, 64);
  if (!maps) return cudaErrorInvalidValue;
  const dim3 grid((a.Sq + T::kBlockM - 1) / T::kBlockM, a.H, a.B);
  flash_bwd_dq_bf16<T><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_dkdv_bf16<DkDvTiles<D>>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_dq_bf16<DqTiles<D>>(p, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid_kv((p.Skv + kWarps - 1) / kWarps, p.Hkv, p.B);
  flash_bwd_dkdv_f32<D><<<grid_kv, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Sq + kWarps - 1) / kWarps, p.H, p.B);
  flash_bwd_dq_f32<D><<<grid_q, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv all of it);
// lse and delta are [B, H, Sq] f32, contiguous. Strides are in elements,
// in the order (batch, sequence, head) for q, k, v, do, dq, dk, dv. Returns
// the CUDA error code of the launches (0 = both kernels launched).
extern "C" int kftpu_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, const void* offset,
    int B, int H, int Hkv, int Sq, int Skv, const long long* strides, float scale, int causal,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.offset = static_cast<const int*>(offset);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  long long* dst[21] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,
                        &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss,
                        &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) err = launch_bf16<128>(p, st);
  if (dtype == 1 && head_dim == 64) err = launch_bf16<64>(p, st);
  if (dtype == 0 && head_dim == 128) err = launch_f32<128>(p, st);
  if (dtype == 0 && head_dim == 64) err = launch_f32<64>(p, st);
  return static_cast<int>(err);
}
