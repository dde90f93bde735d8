// Rotary position embeddings of q and k in one launch, for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes); see
// kubeflow_tpu_torch/ops/rope.py.
//
// Replaces the XLA fusion of kubeflow_tpu/ops/rope.py::apply_rope (:21),
// which jax.jit makes of its position gather, upcast, split, four
// multiplies, add and subtract, concatenate and cast, once for q and once
// for k. There is no Pallas kernel behind it.
//
// Function, split-half convention: for x [B, S, H, D] (q, then k with its
// own head count) and the position p = clamp(positions[b, s], 0, L - 1) of
// each (b, s), with c = cos[p, i], s = sin[p, i] (tables [L, D/2] f32) and
// x1 = x[..., i], x2 = x[..., D/2 + i]:
//   forward  out1 = x1 c - x2 s,  out2 = x2 c + x1 s;
//   inverse  out1 = x1 c + x2 s,  out2 = x2 c - x1 s  (the backward: the
//   transpose of a rotation is the rotation by -p).
// Every product and sum is one f32 operation rounded to nearest (no fused
// multiply-add), as the plain version's separate tensor ops are, and the
// result is rounded once to x's dtype, so kernel and plain agree bitwise.
// Each operand, inputs and outputs alike, is a strided view [B, S, H / G,
// G, D] (D contiguous): head h sits at (h / G) * sh + (h % G) * sg. G = 1
// is an ordinary [B, S, H, D] view. With G > 1 the kernel reads q in place
// from the fused projection [B, S, Hkv, G + 2, D] of
// kubeflow_tpu/models/llama.py:256-264 (q = qkv[..., :G, :] reshaped: head
// h is kv head h / G, slot h % G) and, in the backward, writes dq and dk
// into their slots of the fused product's gradient.
//
// Bound on this card: bytes. Reads q and k once and writes them once (4
// bytes an element in bf16; the tables' rows come from L2): at the training
// shape, q [12, 2047, 16, 128] and k [12, 2047, 8, 128], 302 MB, 90 us.
//
// Design: one thread per 8 pairs (x1 and x2 each one 16-byte load in bf16),
// consecutive threads on consecutive pairs of a head, then heads, then
// tokens, so a warp reads whole 128-byte lines; no shared memory.

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;

struct Params {
  const void* x[2];       // q, k (k may be null: Hn[1] == 0)
  void* out[2];
  // Strides in elements of the inputs (s) and outputs (o) over B, S, the
  // head group (h / G) and the head within it (h % G).
  long long sb[2], ss[2], sh[2], sg[2];
  long long ob[2], os[2], oh[2], og[2];
  int G[2];
  int Hn[2];
  int B, S, D;
  const void* pos;
  long long pb, ps;
  const float* cos;
  const float* sin;
  int L;
};

template <typename T, typename P, bool kInverse>
__global__ void __launch_bounds__(kThreads) rope_kernel(Params p, long long items) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= items) return;
  const int half = p.D / 2;
  const int per_head = half / 8;
  const int heads = p.Hn[0] + p.Hn[1];
  const int chunk = static_cast<int>(t % per_head);
  const long long rest = t / per_head;
  int h = static_cast<int>(rest % heads);
  const long long token = rest / heads;
  const int b = static_cast<int>(token / p.S);
  const int s = static_cast<int>(token % p.S);
  const int which = h < p.Hn[0] ? 0 : 1;
  if (which) h -= p.Hn[0];

  long long pos = static_cast<long long>(
      static_cast<const P*>(p.pos)[b * p.pb + s * p.ps]);
  pos = pos < 0 ? 0 : (pos >= p.L ? p.L - 1 : pos);
  float c[8], sn[8], x1[8], x2[8], o1[8], o2[8];
  load8(p.cos + pos * half + chunk * 8, c);
  load8(p.sin + pos * half + chunk * 8, sn);
  const int hg = h / p.G[which], hi = h % p.G[which];
  const T* src = static_cast<const T*>(p.x[which]) + b * p.sb[which] + s * p.ss[which] +
                 hg * p.sh[which] + hi * p.sg[which] + chunk * 8;
  load8(src, x1);
  load8(src + half, x2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (kInverse) {
      o1[j] = __fadd_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
      o2[j] = __fsub_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], sn[j]));
    } else {
      o1[j] = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
      o2[j] = __fadd_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], sn[j]));
    }
  }
  T* dst = static_cast<T*>(p.out[which]) + b * p.ob[which] + s * p.os[which] +
           hg * p.oh[which] + hi * p.og[which] + chunk * 8;
  store8(dst, o1);
  store8(dst + half, o2);
}

template <typename T, typename P>
cudaError_t launch(const Params& p, bool inverse, cudaStream_t st) {
  const long long items =
      static_cast<long long>(p.B) * p.S * (p.Hn[0] + p.Hn[1]) * (p.D / 16);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (inverse) {
    rope_kernel<T, P, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p, items);
  } else {
    rope_kernel<T, P, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p, items);
  }
  return cudaGetLastError();
}

}  // namespace

// Rotates q (Hq heads) and, when k is not null, k (Hk heads) into qo and
// ko. ``dtype`` 0 = f32, 1 = bf16 (q, k and the outputs alike).
// ``strides``: 16 values in elements, for q then k: the input's over B, S,
// head group and head within the group, then the output's likewise (D
// contiguous, every row start 16-byte aligned); qg and kg the group sizes
// (head h at group h / G, place h % G). positions [B, S] int32 (pos_int64 =
// 0) or int64 with strides pb, ps; cos, sin [L, D/2] f32 contiguous; D a
// multiple of 16. ``inverse`` rotates by -p (the backward). Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int kftpu_rope(int dtype, int pos_int64, int inverse, const void* q, const void* k,
                          void* qo, void* ko, int B, int S, int Hq, int Hk, int D,
                          const long long* strides, int qg, int kg, const void* positions,
                          long long pb, long long ps, const void* cos, const void* sin, int L,
                          void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || B < 1 || S < 1 || Hq < 1 || Hk < 0 || D < 16 ||
      D % 16 != 0 || L < 1 || strides == nullptr || qg < 1 || kg < 1 || Hq % qg != 0 ||
      (Hk > 0 && (k == nullptr || ko == nullptr || Hk % kg != 0))) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.x[0] = q;
  p.x[1] = k;
  p.out[0] = qo;
  p.out[1] = ko;
  for (int i = 0; i < 2; ++i) {
    const long long* st = strides + 8 * i;
    p.sb[i] = st[0]; p.ss[i] = st[1]; p.sh[i] = st[2]; p.sg[i] = st[3];
    p.ob[i] = st[4]; p.os[i] = st[5]; p.oh[i] = st[6]; p.og[i] = st[7];
  }
  p.G[0] = qg;
  p.G[1] = kg;
  p.Hn[0] = Hq;
  p.Hn[1] = Hk;
  p.B = B;
  p.S = S;
  p.D = D;
  p.pos = positions;
  p.pb = pb;
  p.ps = ps;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.L = L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return pos_int64 ? launch<__nv_bfloat16, long long>(p, inverse, st)
                     : launch<__nv_bfloat16, int>(p, inverse, st);
  }
  return pos_int64 ? launch<float, long long>(p, inverse, st) : launch<float, int>(p, inverse, st);
}
