// Decode attention for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes); see kubeflow_tpu_torch/ops/decode_attention.py.
//
// Replaces the XLA-fused decode attention of the JAX model,
// kubeflow_tpu/models/llama.py::Attention._decode_attention (the masked
// mha_reference over the dense cache, int8 scales included) and
// _staged_decode_attention (one softmax over the flushed cache and the
// chunk's staging rows). There is no Pallas kernel behind it: on the TPU,
// XLA fuses the cache's dtype convert into the two einsums.
//
// Function: one query row per (slot, head), Sq == 1. Every query head of
// a kv head (G = H / Hkv) is served by one pass over that kv head's rows.
// Slot b sees cache rows [0, min(lengths[b], L)) and, when staged, staging
// rows [0, stage_rows). Logits are f32 (q and k as f32), times scale and,
// for an int8 cache, k's row scale; the softmax is f32; each weight is
// multiplied by v's row scale (int8 cache) and rounded to bf16 before its
// product with v, as mha_reference rounds the weights to the activation
// dtype; products accumulate in f32; o is written in bf16. The weight that
// is rounded is the online softmax's unnormalised one (relative to the
// running max); the sum divides at the end.
//
// Bound on this card: bytes. Per kv row and kv head it reads D k and D v
// values (2 bytes each in bf16, 1 in int8, plus two f32 scales) and does
// 4 G D flops: at G = 4 that is 8 flops a byte (bf16), far below the ~295
// at which the tensor cores would become the limit. So the least time is
// (live cache bytes + q + o) / 3.35 TB/s, and the design reads each live
// row exactly once with 16-byte loads (8-byte for int8) and never touches
// the rows past a slot's live length:
// - Grid (split, kv head, slot). A split is split_rows consecutive cache
//   rows; the split count depends only on L, so one captured CUDA graph
//   serves every length: a split wholly past the slot's live length exits
//   at once. When staged, one extra split reads the staging rows.
// - A block of 128 threads. D / 8 lanes share one kv row (8 values each);
//   the block walks its split's rows kRows at a time per lane group, loads
//   first, then reduces the G dot products over the lanes with shuffles and
//   runs the online softmax in registers.
// - The lane groups' (m, l, acc) merge in shared memory, and the split's
//   partial result goes to an f32 scratch [B, H, splits, D] (+ m, l); a
//   second small kernel merges a slot's live splits and writes o.
// Capture-safe: lengths are read on the device, nothing is allocated (the
// wrapper passes the scratch), and both kernels go on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;            // rows a lane group loads before computing
constexpr float kNegInf = -1e30f;   // finite: empty groups merge to weight 0

struct Params {
  const __nv_bfloat16* q;           // [B, 1, H, D] via q_sb, q_sh
  const void* k;                    // cache [B, L, Hkv, D]: bf16 or int8
  const void* v;
  const float* k_scale;             // [B, L, Hkv, 1] f32 (int8 cache)
  const float* v_scale;
  const int* lengths;               // [B] int32: live cache rows
  const __nv_bfloat16* sk;          // staging [B, C, Hkv, D] bf16
  const __nv_bfloat16* sv;
  int stage_rows;                   // staging rows live (stage_step + 1), 0 = unstaged
  __nv_bfloat16* o;                 // [B, H, D] contiguous
  float* part_acc;                  // [B, H, splits, D]
  float* part_ml;                   // [B, H, splits, 2]
  int B, H, Hkv, L, num_splits, split_rows;
  long long q_sb, q_sh, c_sb, c_ss, c_sh, s_sb, s_ss, s_sh, st_sb, st_ss, st_sh;
  float scale;
};

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void int8x8_to_float(const uint2& u, float* f) {
  int8_t b[8];
  memcpy(b, &u, 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}

// Loads lane's 8 values of one row: 16 bytes of bf16, or 8 of int8.
template <bool INT8>
__device__ __forceinline__ void load8(const void* base, long long off, float* f) {
  if (INT8) {
    uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + off));
    int8x8_to_float(u, f);
  } else {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off));
    bf16x8_to_float(u, f);
  }
}

template <int D, int G, bool INT8>
__global__ void __launch_bounds__(kThreads) decode_attn_split(const Params p) {
  constexpr int kLanes = D / 8;               // lanes per kv row
  constexpr int kGroups = kThreads / kLanes;  // kv rows per block pass
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const bool stage = p.stage_rows > 0 && split == p.num_splits;
  int r0, r1;
  if (stage) {
    r0 = 0;
    r1 = p.stage_rows;
  } else {
    const int live = min(p.lengths[b], p.L);
    r0 = split * p.split_rows;
    r1 = min(r0 + p.split_rows, live);
    if (r0 >= r1) return;                     // wholly past the live rows
  }
  const int tid = threadIdx.x, group = tid / kLanes, lane = tid % kLanes;
  const bool quant = INT8 && !stage;          // staging rows are bf16

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp = p.q + b * p.q_sb + (hk * G + g) * p.q_sh + lane * 8;
    bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(qp)), qf[g]);
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  // The trip count is uniform over the block (the shuffles need every
  // lane); rows past r1 load nothing and update nothing.
  for (int base = r0; base < r1; base += kRows * kGroups) {
    float kf[kRows][8], vf[kRows][8], ksc[kRows], vsc[kRows];
    bool valid[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * kGroups + group;
      valid[r] = row < r1;
      ksc[r] = vsc[r] = 1.f;
      if (!valid[r]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[r][i] = vf[r][i] = 0.f;
      } else if (stage) {
        const long long off = b * p.st_sb + row * p.st_ss + hk * p.st_sh + lane * 8;
        load8<false>(p.sk, off, kf[r]);
        load8<false>(p.sv, off, vf[r]);
      } else {
        const long long off = b * p.c_sb + row * p.c_ss + hk * p.c_sh + lane * 8;
        load8<INT8>(p.k, off, kf[r]);
        load8<INT8>(p.v, off, vf[r]);
        if (quant) {
          const long long so = b * p.s_sb + row * p.s_ss + hk * p.s_sh;
          ksc[r] = __ldg(p.k_scale + so);
          vsc[r] = __ldg(p.v_scale + so);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qf[g][i], kf[r][i], s);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (!valid[r]) continue;
        s = s * p.scale;
        if (quant) s = s * ksc[r];
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
        const float w = __bfloat162float(__float2bfloat16(quant ? pr * vsc[r] : pr));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(w, vf[r][i], acc[g][i] * corr);
        m[g] = m_new;
      }
    }
  }

  // Merge the lane groups, then write the split's partial (acc, m, l).
  __shared__ float sm_m[kGroups][G];
  __shared__ float sm_l[kGroups][G];
  __shared__ float sm_acc[kGroups][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[group][g][lane * 8 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) mx = fmaxf(mx, sm_m[j][g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float w = expf(sm_m[j][g] - mx);
      a = fmaf(sm_acc[j][g][d], w, a);
      ls = fmaf(sm_l[j][g], w, ls);
    }
    const long long slot = (static_cast<long long>(b) * p.H + hk * G + g) * splits + split;
    p.part_acc[slot * D + d] = a;
    if (d == 0) {
      p.part_ml[slot * 2] = mx;
      p.part_ml[slot * 2 + 1] = ls;
    }
  }
}

// One block per (head, slot), one thread per output column: merges the
// slot's live splits (the same count the split kernel derived) and writes o.
template <int D>
__global__ void __launch_bounds__(D) decode_attn_merge(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int live = min(p.lengths[b], p.L);
  const int main_splits = min(p.num_splits, (max(live, 0) + p.split_rows - 1) / p.split_rows);
  const bool staged = p.stage_rows > 0;
  const int splits = p.num_splits + (staged ? 1 : 0);
  const long long base = (static_cast<long long>(b) * p.H + h) * splits;
  const int n = main_splits + (staged ? 1 : 0);
  float mx = kNegInf;
  for (int j = 0; j < n; ++j) {
    const int s = j < main_splits ? j : p.num_splits;
    mx = fmaxf(mx, p.part_ml[(base + s) * 2]);
  }
  float a = 0.f, ls = 0.f;
  for (int j = 0; j < n; ++j) {
    const int s = j < main_splits ? j : p.num_splits;
    const float w = expf(p.part_ml[(base + s) * 2] - mx);
    a = fmaf(p.part_acc[(base + s) * D + d], w, a);
    ls = fmaf(p.part_ml[(base + s) * 2 + 1], w, ls);
  }
  // No live row at all (mha_reference's fully masked row): o = 0.
  p.o[(static_cast<long long>(b) * p.H + h) * D + d] = __float2bfloat16(ls > 0.f ? a / ls : 0.f);
}

template <int D, int G, bool INT8>
cudaError_t launch(const Params& p, cudaStream_t st) {
  dim3 grid(p.num_splits + (p.stage_rows > 0 ? 1 : 0), p.Hkv, p.B);
  decode_attn_split<D, G, INT8><<<grid, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_merge<D><<<dim3(p.H, p.B), D, 0, st>>>(p);
  return cudaGetLastError();
}

template <int D, bool INT8>
cudaError_t launch_group(const Params& p, int group, cudaStream_t st) {
  switch (group) {
    case 1: return launch<D, 1, INT8>(p, st);
    case 2: return launch<D, 2, INT8>(p, st);
    case 4: return launch<D, 4, INT8>(p, st);
    case 8: return launch<D, 8, INT8>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q_sb, q_sh, cache (k and v) sb/ss/sh, scales sb/ss/sh, staging
// (k and v) sb/ss/sh, in elements.
extern "C" int kftpu_decode_attention(
    int head_dim, int group, int kv_int8, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lengths, const void* stage_k,
    const void* stage_v, int stage_rows, void* o, void* part_acc, void* part_ml, int B, int Hkv,
    int L, int num_splits, int split_rows, const long long* strides, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.sk = static_cast<const __nv_bfloat16*>(stage_k);
  p.sv = static_cast<const __nv_bfloat16*>(stage_v);
  p.stage_rows = stage_rows;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.H = Hkv * group;
  p.Hkv = Hkv;
  p.L = L;
  p.num_splits = num_splits;
  p.split_rows = split_rows;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.c_sb = strides[2];
  p.c_ss = strides[3];
  p.c_sh = strides[4];
  p.s_sb = strides[5];
  p.s_ss = strides[6];
  p.s_sh = strides[7];
  p.st_sb = strides[8];
  p.st_ss = strides[9];
  p.st_sh = strides[10];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || num_splits <= 0 || split_rows <= 0) return cudaErrorInvalidValue;
  if (head_dim == 128) {
    return kv_int8 ? launch_group<128, true>(p, group, st) : launch_group<128, false>(p, group, st);
  }
  if (head_dim == 64) {
    return kv_int8 ? launch_group<64, true>(p, group, st) : launch_group<64, false>(p, group, st);
  }
  return cudaErrorInvalidValue;
}
