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
// max(lse * log2e, -1e29) clamp as the TPU kernel, so its grads are exactly
// 0. The causal offset (q position of row 0 minus kv position of col 0) is
// read from a device int32 pointer, as in the forward.
//
// Layout: q, do, dq [B, Sq, H, D] and k, v, dk, dv [B, Skv, Hkv, D] are read
// and written through their strides (last dim contiguous).
//
// Bound on this card: the five products over the live (q, kv) pairs,
// 10 * B * H * live * D FLOPs, against the bytes of q, k, v, do, dq, dk, dv
// and the statistics: at the training shape (S = 2048, D = 128) about 850
// FLOP per byte, so the tensor cores bound it and the design keeps the
// S x S matrices out of device memory and runs every product on them
// (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// The TPU kernel is one fused pass that keeps the whole query group's dq in
// VMEM across a sequential grid. CUDA blocks run in any order with no state
// between them, so this file splits the work into two deterministic
// kernels and needs no atomics:
//
// (a) dk/dv: one block per (64-row kv tile, kv head, batch). Each warp owns
//     16 kv rows and works in the transposed domain: s^T = K Q^T puts the
//     kv rows on the accumulator rows, so p^T and ds^T re-pack into A
//     fragments in registers (as the forward re-packs P) and the products
//     p^T do and ds^T q need no transpose through shared memory. The block
//     loops over the G query heads and over the q tiles that the causal
//     bound lets through, with dk/dv in f32 registers.
// (b) dq: one block per (64-row q tile, head, batch), four warps of 16 q
//     rows, looping over the live kv tiles and recomputing s, p and dp.
//
// The cost of the split: s and p are computed twice (once per kernel), and
// dp twice, against the fused pass's once: 7 products instead of 5. A
// first version that is right; a fused pass with a cross-block dq
// reduction, ldmatrix fragments, cp.async/TMA and wgmma are later work.
//
// f32: plain FMA kernels, one warp per kv row (dk/dv) and per q row (dq);
// a correctness path (the model trains bf16).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float kPosBig = 1e30f;    // lse2 of q rows past the edge: p = 0
constexpr int kBlockKV = 64;        // kv rows per dk/dv block and per dq tile
constexpr int kBlockQ = 64;         // q rows per dq block

// q rows per tile of the dk/dv kernel: 32 at D = 128 keeps its f32 dk and
// dv accumulators (2 x 64 registers a thread) beside s and dp in registers.
template <int D>
struct DkDvTile {
  static constexpr int kRows = D == 128 ? 32 : 64;
};

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

// Writes this thread's two accumulator rows (r, r + 8 within the tile at
// ``row0``) of a [.., D] f32 accumulator, times ``mul``, as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           int row0, int rows_valid, int r, int t4,
                                           const float (&acc)[D / 8][4], float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r + 8 * i;
    if (rr >= rows_valid) continue;
    __nv_bfloat16* out = base + (row0 + rr) * row_stride + t4 * 2;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(out + dn * 8) =
          __floats2bfloat162_rn(acc[dn][2 * i] * mul, acc[dn][2 * i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- bf16 (a)

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_bf16(Params p) {
  constexpr int kBQ = DkDvTile<D>::kRows;
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBlockKV * kLd;
  __nv_bfloat16* sQ = sV + kBlockKV * kLd;
  __nv_bfloat16* sDo = sQ + kBQ * kLd;
  float* sLse = reinterpret_cast<float*>(sDo + kBQ * kLd);
  float* sDelta = sLse + kBQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Low kv tiles first: under the causal mask they see the most q tiles.
  const int n0 = blockIdx.x * kBlockKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int off = p.causal ? *p.offset : 0;
  const int kv_valid = min(kBlockKV, p.Skv - n0);

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                            n0 * p.k_ss + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                            n0 * p.v_ss + hk * p.v_sh;
  load_tile<D, kBlockKV>(sK, kb, p.k_ss, kv_valid);
  load_tile<D, kBlockKV>(sV, vb, p.v_ss, kv_valid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }
  const int r0 = warp * 16 + g;        // this thread's kv rows: r0, r0 + 8

  // Causal: q row i sees kv col j iff i + off >= j, so no q row before
  // n0 - off reaches this tile.
  const int m_first = p.causal ? max(0, n0 - off) : 0;
  const int t_begin = m_first / kBQ;
  const int t_end = (p.Sq + kBQ - 1) / kBQ;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* doh =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int t = t_begin; t < t_end; ++t) {
      const int m0 = t * kBQ;
      const int q_valid = min(kBQ, p.Sq - m0);
      __syncthreads();   // every warp is done with the previous q tile
      load_tile<D, kBQ>(sQ, qh + m0 * p.q_ss, p.q_ss, q_valid);
      load_tile<D, kBQ>(sDo, doh + m0 * p.do_ss, p.do_ss, q_valid);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool ok = i < q_valid;
        const long long idx = stat_index(p, b, h, m0 + i);
        // Rows past the edge: lse2 = +1e30 makes p = 0 (and do is 0).
        sLse[i] = ok ? fmaxf(p.lse[idx] * kLog2e, kMClamp) : kPosBig;
        sDelta[i] = ok ? p.delta[idx] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T: this warp's 16 kv rows x kBQ q columns.
      float s[kBQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4];
        load_a_frag<D>(a, sK, r0, kc * 16 + t4 * 2);
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows<D>(b0, b1, sQ, nt * 8 + g, kc * 16 + t4 * 2);
          mma_16816(s[nt], a, b0, b1);
        }
      }

      // p^T = exp2(s^T * scale * log2e - lse2[q]); only tiles the causal
      // diagonal cuts are masked (the ragged edges need no mask: q rows
      // past Sq have p = 0, kv rows past Skv are never stored).
      const bool need_mask = p.causal && (m0 + off < n0 + kBlockKV - 1);
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + t4 * 2 + (e & 1);
          float x = s[nt][e] * p.scale_log2;
          if (need_mask && m0 + qc + off < n0 + r0 + (e >> 1) * 8) x = kNegInf;
          s[nt][e] = exp2f(x - sLse[qc]);
        }
      }

      // dv += p^T do: p^T re-packs into A fragments; do gathered by column.
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t b0, b1;
          load_b_cols<D>(b0, b1, sDo, kk * 16 + t4 * 2, dn * 8 + g);
          mma_16816(dv[dn], pa, b0, b1);
        }
      }

      // dp^T = V do^T, then ds^T = p^T (dp^T - delta[q]) in place.
      float dp[kBQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4];
        load_a_frag<D>(a, sV, r0, kc * 16 + t4 * 2);
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows<D>(b0, b1, sDo, nt * 8 + g, kc * 16 + t4 * 2);
          mma_16816(dp[nt], a, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + t4 * 2 + (e & 1);
          dp[nt][e] = s[nt][e] * (dp[nt][e] - sDelta[qc]);
        }
      }

      // dk += ds^T q (scaled at the store).
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t da[4];
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t b0, b1;
          load_b_cols<D>(b0, b1, sQ, kk * 16 + t4 * 2, dn * 8 + g);
          mma_16816(dk[dn], da, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
  store_rows<D>(dkb, p.dk_ss, n0, kv_valid, r0, t4, dk, p.scale);
  store_rows<D>(dvb, p.dv_ss, n0, kv_valid, r0, t4, dv, 1.f);
}

// ---------------------------------------------------------------- bf16 (b)

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(Params p) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDo = sQ + kBlockQ * kLd;
  __nv_bfloat16* sK = sDo + kBlockQ * kLd;
  __nv_bfloat16* sV = sK + kBlockKV * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Last q tiles first: under the causal mask they carry the most kv tiles.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.causal ? *p.offset : 0;
  const int q_valid = min(kBlockQ, p.Sq - m0);

  load_tile<D, kBlockQ>(sQ, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                                m0 * p.q_ss + h * p.q_sh,
                        p.q_ss, q_valid);
  load_tile<D, kBlockQ>(sDo, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb +
                                 m0 * p.do_ss + h * p.do_sh,
                        p.do_ss, q_valid);
  const int r0 = warp * 16 + g;        // this thread's q rows: r0, r0 + 8
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r0 + 8 * i;
    const bool ok = row < p.Sq;
    lse2[i] = ok ? fmaxf(p.lse[stat_index(p, b, h, row)] * kLog2e, kMClamp) : kPosBig;
    delta[i] = ok ? p.delta[stat_index(p, b, h, row)] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  int n_end = p.Skv;
  if (p.causal) n_end = min(n_end, m0 + q_valid - 1 + off + 1);
  const int n_tiles = n_end > 0 ? (n_end + kBlockKV - 1) / kBlockKV : 0;
  const int q_pos0 = m0 + r0 + off;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockKV;
    const int kv_valid = min(kBlockKV, p.Skv - n0);
    __syncthreads();   // every warp is done with the previous kv tile
    load_tile<D, kBlockKV>(sK, kb + n0 * p.k_ss, p.k_ss, kv_valid);
    load_tile<D, kBlockKV>(sV, vb + n0 * p.v_ss, p.v_ss, kv_valid);
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's 16 q rows x 64 kv columns.
    float s[kBlockKV / 8][4], dp[kBlockKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      load_a_frag<D>(qa, sQ, r0, kc * 16 + t4 * 2);
      load_a_frag<D>(da, sDo, r0, kc * 16 + t4 * 2);
#pragma unroll
      for (int nt = 0; nt < kBlockKV / 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows<D>(b0, b1, sK, nt * 8 + g, kc * 16 + t4 * 2);
        mma_16816(s[nt], qa, b0, b1);
        load_b_rows<D>(b0, b1, sV, nt * 8 + g, kc * 16 + t4 * 2);
        mma_16816(dp[nt], da, b0, b1);
      }
    }

    // p = exp2(s * scale * log2e - lse2), masked where the ragged kv edge
    // or the causal diagonal cuts the tile; ds = p (dp - delta) in place.
    const bool need_mask =
        (n0 + kBlockKV > p.Skv) || (p.causal && (m0 + off < n0 + kBlockKV - 1));
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (need_mask) {
          const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
          const int qp = q_pos0 + (e >> 1) * 8;
          const bool live = col < p.Skv && (!p.causal || qp >= col);
          x = live ? x : kNegInf;
        }
        const float pe = exp2f(x - lse2[e >> 1]);
        dp[nt][e] = pe * (dp[nt][e] - delta[e >> 1]);
      }
    }

    // dq += ds K (scaled at the store): ds re-packs into A fragments, K is
    // gathered by column.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      pa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      pa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      pa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, sK, kk * 16 + t4 * 2, dn * 8 + g);
        mma_16816(dq[dn], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<D>(dqb, p.dq_ss, m0, q_valid, r0, t4, dq, p.scale);
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

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kLd = D + kPad;
  constexpr int kBQ = DkDvTile<D>::kRows;
  constexpr int kSmemDkDv = (2 * kBlockKV + 2 * kBQ) * kLd * 2 + 2 * kBQ * 4;
  constexpr int kSmemDq = (2 * kBlockQ + 2 * kBlockKV) * kLd * 2;
  static bool dkdv_set = false, dq_set = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_bf16<D>, kSmemDkDv, dkdv_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_bf16<D>, kSmemDq, dq_set);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.Skv + kBlockKV - 1) / kBlockKV, p.Hkv, p.B);
  flash_bwd_dkdv_bf16<D><<<grid_kv, kThreads, kSmemDkDv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_bwd_dq_bf16<D><<<grid_q, kThreads, kSmemDq, stream>>>(p);
  return cudaGetLastError();
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
