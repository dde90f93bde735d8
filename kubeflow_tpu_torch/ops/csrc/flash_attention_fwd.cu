// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see kubeflow_tpu_torch/ops/flash_attention.py.
//
// Replaces kubeflow_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// forward kernel). Same function: blockwise causal or full softmax
// attention with GQA (kv head = h / G, never repeated), online softmax in
// the base-2 domain, o in the input dtype and lse [B, H, Sq] in f32 natural
// log. A fully masked row gives o = 0 and lse = -1e30. The causal offset
// (q position of row 0 minus kv position of col 0) is read from a device
// int32 pointer so a caller can pass a tensor without a host sync.
//
// Layout: q [B, Sq, H, D] and k/v [B, Skv, Hkv, D] are read through their
// strides (last dim contiguous, strides a multiple of 8 elements), so the
// model layout needs no transpose. o is written as [B, Sq, H, D] through
// its strides; lse is contiguous.
//
// Bound on this card: max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), FLOPs =
// 4 B H D x (live q-kv pairs). Serving prefill B=8, S=512, H=32/8, D=128
// causal: 0.0252 ms, set by bytes. Training B=12, S=2048, H=16/8, D=128
// causal: 2.06e11 FLOP = 0.2086 ms against 303.6 MB = 0.091 ms, set by
// operations. Both products therefore run on wgmma, the only path to the
// tensor cores' full rate, fed by TMA so that no thread spends registers or
// issue slots on loads; scores and probabilities never leave registers.
//
// bf16 design (FlashAttention-3's shape):
// - Work: one unit per (q tile, head, batch). The kernel is persistent: one
//   block per SM (two for the 64-row tiles) takes one unit per round, the
//   rounds alternating direction so that heavy and light causal units even
//   out. The q tiles of a (head, batch) are neighbours, last (heaviest)
//   first, and so are the heads of a kv head: the blocks running together
//   read the same k/v tiles, from L2. Persistent, because with one
//   384-thread block per SM a block per unit could overlap its q load,
//   setup and epilogue with nothing (~8 us a unit, PERF.md).
// - Warp roles: warpgroup 0 is the producer. It gives up registers
//   (setmaxnreg 24) and one thread issues every TMA load: each unit's q
//   tile once q's slot is free (after the previous unit's last S), then k
//   and v tiles into a 2-stage ring with a full barrier per tile and
//   separate empty barriers for k and v, so k runs a tile ahead of v. It
//   reads the causal offset and skips dead kv tiles exactly as the
//   consumers do, so both agree on the tile count. Warpgroups 1.. are
//   consumers, 64 q rows each, with registers raised by setmaxnreg.
// - S = Q K^T: wgmma m64nNk16, both operands in shared memory, K-major
//   (D contiguous) in 128-byte-swizzled boxes of 64 columns (a TMA box's
//   inner extent cannot exceed the 128-byte swizzle, so D = 128 is two
//   boxes and the descriptor steps across them).
// - Softmax in registers: the wgmma accumulator gives each warp the m16n8
//   row pattern of mma.sync, so row max and sum reduce over the quad. Only
//   tiles cut by the diagonal or the ragged kv edge are masked; rows and
//   columns past the edges arrive as TMA's zero fill. p = 2^(s scale - m)
//   is one FFMA and one MUFU.EX2 per score.
// - O += P V: P is rounded to bf16 in registers and is the register A
//   operand of wgmma (its layout is the m16n8k16 A fragment, a repack of
//   the S accumulator); V is the B operand from shared memory, MN-major (d
//   contiguous), with the transpose-B flag.
// - Overlap: inside a warpgroup, S of tile t and P V of tile t - 1 are
//   issued together and the softmax of tile t runs while P V does; the
//   two consumer warpgroups take turns to issue (named barriers), so one's
//   softmax runs while the tensor cores work for the other.
// - Epilogue: o = acc / l is staged in its own shared tile in the swizzled
//   layout and written by a TMA store, which clips rows >= Sq; the next
//   unit's products overlap the store. lse = m ln2 + log l.
// - Tiles: Sq > 64 takes 128-row q tiles (two consumer warpgroups) and
//   128-row kv tiles: shared memory 32 KB q + 2 x (32 KB k + 32 KB v) +
//   32 KB o = 192 KB at D = 128 (half at D = 64), 384 threads. Registers
//   per consumer thread: S 64 f32, O 64 f32 (D = 128), P 32 b32, under
//   setmaxnreg 240 (producer 24: 128 x 24 + 256 x 240 <= 64 K), no spills.
//   Sq <= 64 (short serving prompts) takes 64-row q and kv tiles with one
//   consumer warpgroup: 96 KB, two blocks per SM (setmaxnreg 24 / 232), so
//   a 128-row tile of mostly padding does not halve the rows in flight.
//
// f32: a plain FMA kernel, one warp per q row (correctness path; the
// serving and training models run bf16).

#include "flash_common.cuh"
#include "hopper_common.cuh"

#include <algorithm>

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* offset;
  int B, H, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;
  int causal;
};

// Tile configuration of the bf16 kernel (see the note above).
template <int D_, int kConsumers_>
struct Tiles {
  static constexpr int D = D_;
  static constexpr int kConsumers = kConsumers_;     // warpgroups of 64 q rows
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kBlockN = kConsumers == 2 ? 128 : 64;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kMinBlocks = kConsumers == 2 ? 1 : 2;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 232;
  static constexpr int kBoxes = D / 64;              // 64-column boxes per tile
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  // 1024 bytes of slack to align the tiles, then q, the k and v rings, the
  // o staging tile and 10 barriers.
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 128;
};

// The bf16 kernel's arguments: the tensor maps of q, k, v (loads) and o
// (stores), passed by value in parameter space.
struct HopperParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  float* lse;
  const int* offset;
  int B, H, Hkv, Sq, Skv;
  int n_m;             // q tiles per (head, batch)
  float scale_log2;
  int causal;
};

// One unit of work: a q tile of one head of one batch row, and how many kv
// tiles it reads.
struct WorkTile {
  int m0, h, b, n_tiles;
};

// Work unit w: the q tiles of one (head, batch) are neighbours, from the
// last (under the causal mask the heaviest) to the first, and so are the
// heads of one kv head: blocks running together read the same k/v tiles,
// which then come from L2.
template <class T>
__device__ __forceinline__ WorkTile work_tile(const HopperParams& p, int w, int off) {
  const int hb = w / p.n_m;
  WorkTile wt;
  wt.m0 = (p.n_m - 1 - w % p.n_m) * T::kBlockM;
  wt.h = hb % p.H;
  wt.b = hb / p.H;
  // Causal skip: kv columns past the tile's last live q position are dead.
  int n_end = p.Skv;
  if (p.causal) n_end = min(n_end, min(wt.m0 + T::kBlockM, p.Sq) + off);
  wt.n_tiles = n_end > 0 ? (n_end + T::kBlockN - 1) / T::kBlockN : 0;
  return wt;
}

// The unit a block takes in its round k. Rounds alternate direction (a
// snake): units of one (head, batch) run from heavy to light, so a block
// that took a heavy unit in one round takes a light one in the next, and
// the blocks' counts of kv tiles even out (plain round robin hands block i
// the same q tile, i mod n_m, in every round when gridDim.x % n_m == 0).
__device__ __forceinline__ int unit_of_round(int k) {
  const int i = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return k * gridDim.x + i;
}

// Persistent: each block walks one work unit per round; the producer loads
// the next unit's q tile while the consumers finish the last one, and the
// k/v ring runs on across units.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    flash_fwd_bf16(const __grid_constant__ HopperParams p) {
  constexpr int D = T::D;
  constexpr int kBlockM = T::kBlockM;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + T::kQBytes;                  // kStages k tiles
  unsigned char* sV = sK + kStages * T::kKVBytes;        // kStages v tiles
  unsigned char* sO = sV + kStages * T::kKVBytes;        // o staging, q's shape
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sO + T::kQBytes);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;                         // [kStages]
  uint64_t* full_v = full_k + kStages;                    // [kStages]
  uint64_t* empty_k = full_v + kStages;                   // [kStages]
  uint64_t* empty_v = empty_k + kStages;                  // [kStages]

  const int off = p.causal ? *p.offset : 0;
  const int n_work = p.n_m * p.H * p.B;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, T::kConsumers * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], T::kConsumers * 128);
      mbar_init(&empty_v[s], T::kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&p.tm_q);
      prefetch_tensor_map(&p.tm_k);
      prefetch_tensor_map(&p.tm_v);
      int kv = 0;   // kv tiles loaded by this block: the ring's position
      // j: work units of this block, the q slot's phase
      for (int j = 0, w; (w = unit_of_round(j)) < n_work; ++j) {
        const WorkTile wt = work_tile<T>(p, w, off);
        const int hk = wt.h / (p.H / p.Hkv);
        mbar_wait(empty_q, (j & 1) ^ 1);   // the first unit passes at once
        mbar_arrive_expect_tx(full_q, T::kQBytes);
#pragma unroll
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load_4d(sQ + bx * kBlockM * 128, &p.tm_q, full_q, bx * 64, wt.m0, wt.h, wt.b);
        }
        for (int t = 0; t < wt.n_tiles; ++t, ++kv) {
          // A k slot frees once S of its tile is done, a v slot once P V
          // is: k tiles run ahead of v tiles.
          const int s = kv % kStages;
          const uint32_t free_parity = ((kv / kStages) & 1) ^ 1;
          unsigned char* k_dst = sK + s * T::kKVBytes;
          unsigned char* v_dst = sV + s * T::kKVBytes;
          mbar_wait(&empty_k[s], free_parity);
          mbar_arrive_expect_tx(&full_k[s], T::kKVBytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx) {
            tma_load_4d(k_dst + bx * kBlockN * 128, &p.tm_k, &full_k[s], bx * 64,
                        t * kBlockN, hk, wt.b);
          }
          mbar_wait(&empty_v[s], free_parity);
          mbar_arrive_expect_tx(&full_v[s], T::kKVBytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx) {
            tma_load_4d(v_dst + bx * kBlockN * 128, &p.tm_v, &full_v[s], bx * 64,
                        t * kBlockN, hk, wt.b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup c: q rows m0 + 64 c .. m0 + 64 c + 63 of each unit.
    reg_alloc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2;             // row within the 8-row half of a warp's 16
    const int t4 = tid & 3;                    // column pair within the quad
    const int r0 = (tid >> 5) * 16 + g;        // this thread's rows: r0 and r0 + 8
    const uint32_t q_addr = smem_u32(sQ) + c * 64 * 128;
    unsigned char* sOw = sO + c * 64 * 128;

    float acc[D / 2];
    float m_run[2];   // rows r0 and r0 + 8, base-2 domain
    float l_run[2];   // this thread's share of the row sums

    // S = Q K^T of ring tile kvi into sc (64 rows x kBlockN columns;
    // element (nt, e) of the m16n8 pattern is sc[4 nt + e]), issued, not
    // awaited.
    float sc[kBlockN / 2];
    auto issue_s = [&](int kvi) {
      const uint32_t k_addr = smem_u32(sK + (kvi % kStages) * T::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;    // 16 bf16 within a 128-byte row
        const uint64_t da = sw128_desc(q_addr + (kk >> 2) * kBlockM * 128 + col, 16, 1024);
        const uint64_t db = sw128_desc(k_addr + (kk >> 2) * kBlockN * 128 + col, 16, 1024);
        if constexpr (kBlockN == 128) {
          wgmma_ss_m64n128k16(sc, da, db, kk > 0);
        } else {
          wgmma_ss_m64n64k16(sc, da, db, kk > 0);
        }
      }
    };
    // O += P V of ring tile kvi: pa holds P as A fragments of 16 kv rows.
    uint32_t pa[kBlockN / 16][4];
    auto issue_pv = [&](int kvi) {
      const uint32_t v_addr = smem_u32(sV + (kvi % kStages) * T::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        // 16 kv rows = two 8-row groups of 1024 bytes; the next 64 d
        // columns are the next box, kBlockN x 128 bytes on.
        const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, kBlockN * 128, 1024);
        if constexpr (D == 128) {
          wgmma_rs_m64n128k16_mn(acc, pa[kk], dv);
        } else {
          wgmma_rs_m64n64k16_mn(acc, pa[kk], dv);
        }
      }
    };
    // Online softmax of the tile at kv column n0 in sc: mask, row max over
    // the quad, exponentiate. Returns the factors that rescale O's rows.
    // The max is taken over the raw scores (scale > 0) and masked scores
    // are -inf there, so p = 2^(s scale - m) is one FFMA and one MUFU.EX2
    // and a masked score gives exactly 0; m stays finite (>= -1e30).
    auto softmax = [&](int n0, int mw, float (&alpha)[2]) {
      const int q_pos0 = mw + r0 + off;
      // Only tiles cut by the ragged kv edge or by the diagonal are masked.
      const bool need_mask =
          (n0 + kBlockN > p.Skv) || (p.causal && (mw + off < n0 + kBlockN - 1));
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int col = n0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
          const int qp = q_pos0 + ((i >> 1) & 1) * 8;
          const bool live = col < p.Skv && (!p.causal || qp >= col);
          sc[i] = live ? sc[i] : -INFINITY;
        }
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
      }
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float m_new = fmaxf(m_run[i], tmax[i] * p.scale_log2);
        alpha[i] = fast_exp2(m_run[i] - m_new);
        base[i] = fmaxf(m_new, kMClamp);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const float pe = fast_exp2(fmaf(sc[i], p.scale_log2, -base[(i >> 1) & 1]));
        sc[i] = pe;
        l_run[(i >> 1) & 1] += pe;
      }
    };
    // P in bf16: the S accumulators of two adjacent n8 tiles are exactly
    // the A fragment of 16 kv rows.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        }
      }
    };

    // Two consumer warpgroups take turns to issue their products (named
    // barriers 3 and 4), so that one's softmax runs while the tensor cores
    // work for the other. Warpgroup 1 opens warpgroup 0's first turn.
    auto turn_begin = [&]() {
      if constexpr (T::kConsumers == 2) named_bar_sync(3 + c, 256);
    };
    auto turn_end = [&]() {
      if constexpr (T::kConsumers == 2) named_bar_arrive(3 + (c ^ 1), 256);
    };
    if (T::kConsumers == 2 && c == 1) named_bar_arrive(3, 256);

    int kv = 0;   // kv tiles consumed by this block: the ring's position
    // j: work units of this block, the q slot's phase
    for (int j = 0, w; (w = unit_of_round(j)) < n_work; ++j) {
      const WorkTile wt = work_tile<T>(p, w, off);
      const int mw = wt.m0 + 64 * c;
      const int n = wt.n_tiles;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = kNegInf;
      l_run[0] = l_run[1] = 0.f;

      // Software pipeline inside the warpgroup: while the tensor cores run
      // P V of tile t - 1 (and S of tile t), the warps run the softmax of
      // tile t. The q slot is released after the unit's last S.
      mbar_wait(full_q, j & 1);
      if (n == 0) mbar_arrive(empty_q);
      if (n > 0) {
        float alpha[2];
        const int s0 = kv % kStages;
        turn_begin();
        mbar_wait(&full_k[s0], (kv / kStages) & 1);
        wgmma_fence();
        issue_s(kv);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_operands(sc);
        mbar_arrive(&empty_k[s0]);
        if (n == 1) mbar_arrive(empty_q);
        softmax(0, mw, alpha);    // O is still 0: nothing to rescale
        pack_p();
        for (int t = 1; t < n; ++t) {
          const int ki = kv + t;
          const int s = ki % kStages;
          const int sp = (ki - 1) % kStages;
          turn_begin();
          mbar_wait(&full_k[s], (ki / kStages) & 1);
          wgmma_fence();
          issue_s(ki);
          wgmma_commit();
          mbar_wait(&full_v[sp], ((ki - 1) / kStages) & 1);
          issue_pv(ki - 1);
          wgmma_commit();
          turn_end();
          wgmma_wait<1>();        // S of tile t is done, P V may run on
          fence_operands(sc);
          mbar_arrive(&empty_k[s]);
          if (t == n - 1) mbar_arrive(empty_q);
          softmax(t * kBlockN, mw, alpha);
          wgmma_wait<0>();
          fence_operands(acc);
          mbar_arrive(&empty_v[sp]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          pack_p();
        }
        const int kl = kv + n - 1;
        const int sl = kl % kStages;
        turn_begin();
        mbar_wait(&full_v[sl], (kl / kStages) & 1);
        wgmma_fence();
        issue_pv(kl);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_operands(acc);
        mbar_arrive(&empty_v[sl]);
        kv += n;
      }

      // o = acc / l and lse = m * ln2 + log(l); rows with l == 0 were fully
      // masked and give o = 0, lse = -1e30.
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = l > 0.f ? 1.f / l : 0.f;
        const int row = mw + r0 + 8 * i;
        if (t4 == 0 && row < p.Sq) {
          p.lse[(static_cast<long long>(wt.b) * p.H + wt.h) * p.Sq + row] =
              l > 0.f ? m_run[i] * kLn2 + logf(l) : kNegInf;
        }
      }
      // Stage o in the swizzled layout of the o map (the 16-byte chunk ch
      // of row r sits at chunk ch ^ (r % 8), and r % 8 == g) once the
      // previous unit's store has read the staging rows; one thread stores.
      if (tid == 0) tma_store_wait_read();
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        unsigned char* box = sOw + (jj >> 3) * kBlockM * 128;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          *reinterpret_cast<uint32_t*>(box + r * 128 + (((jj & 7) ^ g) << 4) + 4 * t4) =
              pack_bf16(acc[4 * jj + 2 * i] * inv[i], acc[4 * jj + 2 * i + 1] * inv[i]);
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_store_4d(&p.tm_o, sOw + bx * kBlockM * 128, bx * 64, mw, wt.h, wt.b);
        }
        tma_store_commit();
      }
    }
    // Warpgroup 1's last turn opened one more turn of warpgroup 0: take it,
    // so that every arrival at barrier 3 is matched.
    if (T::kConsumers == 2 && c == 0) named_bar_sync(3, 256);
    if (tid == 0) tma_store_wait_read();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;   // heavy rows first
  if (row >= p.Sq) return;   // warp-uniform
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.causal ? *p.offset : 0;

  const float* qr = static_cast<const float*>(p.q) + b * p.q_sb + row * p.q_ss +
                    h * p.q_sh + lane * kPer;
  const float* kr = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + lane * kPer;
  const float* vr = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + lane * kPer;
  float q[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    q[i] = qr[i];
    acc[i] = 0.f;
  }
  int n_end = p.Skv;
  if (p.causal) n_end = min(n_end, row + off + 1);
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < n_end; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) s = fmaf(q[i], kr[j * p.k_ss + i], s);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    s *= p.scale_log2;
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new);
    const float pj = exp2f(s - m_new);
    l = l * alpha + pj;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, vr[j * p.v_ss + i], acc[i] * alpha);
    m = m_new;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* orow = static_cast<float*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh + lane * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) orow[i] = acc[i] * inv;
  if (lane == 0) {
    p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
        l > 0.f ? m * kLn2 + logf(l) : kNegInf;
  }
}

// The current device's SM count, asked of the runtime once per device.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (cached[device] == 0) {
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[device];
  return cudaSuccess;
}

template <class T>
cudaError_t launch_bf16(const Params& a, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(flash_fwd_bf16<T>, T::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  HopperParams p;
  const bool maps =
      encode_bshd_bf16(&p.tm_q, a.q, a.B, a.Sq, a.H, T::D, a.q_ss, a.q_sh, a.q_sb, T::kBlockM) &&
      encode_bshd_bf16(&p.tm_k, a.k, a.B, a.Skv, a.Hkv, T::D, a.k_ss, a.k_sh, a.k_sb,
                       T::kBlockN) &&
      encode_bshd_bf16(&p.tm_v, a.v, a.B, a.Skv, a.Hkv, T::D, a.v_ss, a.v_sh, a.v_sb,
                       T::kBlockN) &&
      encode_bshd_bf16(&p.tm_o, a.o, a.B, a.Sq, a.H, T::D, a.o_ss, a.o_sh, a.o_sb, 64);
  if (!maps) return cudaErrorInvalidValue;
  p.lse = a.lse;
  p.offset = a.offset;
  p.B = a.B;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Skv = a.Skv;
  p.n_m = (a.Sq + T::kBlockM - 1) / T::kBlockM;
  p.scale_log2 = a.scale_log2;
  p.causal = a.causal;
  const long long n_work = static_cast<long long>(p.n_m) * a.H * a.B;
  const int grid = static_cast<int>(std::min<long long>(n_work, sms * T::kMinBlocks));
  flash_fwd_bf16<T><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Sq <= 64 (short serving prompts) takes the 64-row tiles.
template <int D>
cudaError_t launch_bf16_tiles(const Params& p, cudaStream_t stream) {
  return p.Sq <= 64 ? launch_bf16<Tiles<D, 1>>(p, stream) : launch_bf16<Tiles<D, 2>>(p, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kWarps - 1) / kWarps, p.H, p.B);
  flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int kftpu_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v, void* o, void* lse,
    const void* offset, int B, int H, int Hkv, int Sq, int Skv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale,
    int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.offset = static_cast<const int*>(offset);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) err = launch_bf16_tiles<128>(p, st);
  if (dtype == 1 && head_dim == 64) err = launch_bf16_tiles<64>(p, st);
  if (dtype == 0 && head_dim == 128) err = launch_f32<128>(p, st);
  if (dtype == 0 && head_dim == 64) err = launch_f32<64>(p, st);
  return static_cast<int>(err);
}
