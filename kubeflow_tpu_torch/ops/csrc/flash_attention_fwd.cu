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
// strides (last dim contiguous), so the model layout needs no transpose.
// o is written as [B, Sq, H, D] through its strides; lse is contiguous.
//
// Bound on this card: max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s). At the
// serving prefill shapes (S <= 512, D = 128) the work is 4*B*H*S^2*D/2
// causal FLOPs against ~2*B*S*(H+2*Hkv)*D*2 bytes, about 200 FLOP per byte:
// memory and tensor-core time are of the same order, so the design keeps
// the S x S scores out of device memory (each q tile streams k/v tiles
// through shared memory once, scores and probabilities live in registers)
// and runs both products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate). Dead kv tiles past the causal diagonal are never
// loaded, and only tiles that the diagonal or the ragged edge cuts pay for
// the mask. This first version does no cp.async/TMA pipelining and no
// wgmma; those are the next steps toward the bound.
//
// bf16: one block per (64-row q tile, head, batch); 4 warps, 16 q rows
// each; 64-row k/v tiles in shared memory.
// f32: a plain FMA kernel, one warp per q row (correctness path; the
// serving model runs bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // finite: fully masked rows stay NaN-free
constexpr float kMClamp = -1e29f;   // exp2(s - max(m, kMClamp)) -> 0 when m == kNegInf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockM = 64;         // q rows per block
constexpr int kBlockN = 64;         // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 row padding: breaks smem bank conflicts

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

// Copies ``rows_valid`` rows of D bf16 (row stride ``row_stride`` elements)
// into a 64-row shared tile with 16-byte loads; rows past the edge are
// zero so the products over them stay finite.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                          long long row_stride, int rows_valid) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + kPad;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + cc * 8);
    }
    *reinterpret_cast<uint4*>(smem + r * kLd + cc * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  static_assert(kBlockM == kBlockN, "load_tile assumes square tiles");
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLd;
  __nv_bfloat16* sV = sK + kBlockN * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row half of an mma tile
  const int t4 = lane & 3;   // column pair within the quad
  // Last q tiles first: under the causal mask they carry the most kv
  // tiles, so starting them early shortens the tail of the grid.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.causal ? *p.offset : 0;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                            m0 * p.q_ss + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<D>(sQ, qb, p.q_ss, min(kBlockM, p.Sq - m0));
  __syncthreads();

  // This warp's 16 q rows as mma A fragments, kept in registers.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* q0 = sQ + r0 * kLd + kc * 16 + t4 * 2;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(q0);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(q0 + 8 * kLd);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(q0 + 8 * kLd + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};   // rows r0 and r0 + 8, base-2 domain
  float l_run[2] = {0.f, 0.f};           // this thread's share of the row sums

  // Causal skip: kv columns past the tile's last live q position are dead.
  int n_end = p.Skv;
  if (p.causal) {
    const int last_q = min(m0 + kBlockM, p.Sq) - 1 + off;
    n_end = min(n_end, last_q + 1);
  }
  const int n_tiles = n_end > 0 ? (n_end + kBlockN - 1) / kBlockN : 0;
  const int q_pos0 = m0 + r0 + off;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    __syncthreads();   // every warp is done reading the previous tile
    load_tile<D>(sK, kb + n0 * p.k_ss, p.k_ss, min(kBlockN, p.Skv - n0));
    load_tile<D>(sV, vb + n0 * p.v_ss, p.v_ss, min(kBlockN, p.Skv - n0));
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns (8 n-tiles of 8).
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* k0 = sK + (nt * 8 + g) * kLd + t4 * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(k0 + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(k0 + kc * 16 + 8);
        mma_16816(s[nt], qf[kc], b0, b1);
      }
    }

    // Only tiles cut by the ragged kv edge or by the diagonal are masked.
    const bool need_mask =
        (n0 + kBlockN > p.Skv) || (p.causal && (m0 + off < n0 + kBlockN - 1));
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (need_mask) {
          const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
          const int qp = q_pos0 + (e >> 1) * 8;
          const bool live = col < p.Skv && (!p.causal || qp >= col);
          x = live ? x : kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax: row max over the quad, rescale, exponentiate.
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[nt][0], s[nt][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      base[i] = fmaxf(m_new, kMClamp);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - base[e >> 1]);
        s[nt][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent n-tiles are exactly an
    // A fragment of P; V's B fragments are gathered from shared memory.
    const unsigned short* vs = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kv = kk * 16 + t4 * 2;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int d = dn * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(vs[kv * kLd + d]) |
                            (static_cast<uint32_t>(vs[(kv + 1) * kLd + d]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vs[(kv + 8) * kLd + d]) |
                            (static_cast<uint32_t>(vs[(kv + 9) * kLd + d]) << 16);
        mma_16816(acc[dn], pa, b0, b1);
      }
    }
  }

  // o = acc / l and lse = m * ln2 + log(l); rows with l == 0 were fully
  // masked and give o = 0, lse = -1e30.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + row * p.o_ss +
                        h * p.o_sh + t4 * 2;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(ob + dn * 8) =
          __floats2bfloat162_rn(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
    }
    if (t4 == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          l > 0.f ? m_run[i] * kLn2 + logf(l) : kNegInf;
    }
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

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = (kBlockM + 2 * kBlockN) * (D + kPad) * 2;
  // Above 48 KB of dynamic shared memory needs an opt-in, once per
  // kernel (racing first calls set the same value).
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  flash_fwd_bf16<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
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
  if (dtype == 1 && head_dim == 128) err = launch_bf16<128>(p, st);
  if (dtype == 1 && head_dim == 64) err = launch_bf16<64>(p, st);
  if (dtype == 0 && head_dim == 128) err = launch_f32<128>(p, st);
  if (dtype == 0 && head_dim == 64) err = launch_f32<64>(p, st);
  return static_cast<int>(err);
}
