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
//
// Staged decode (kftpu_rope_stage): a decode step's one token a row, with
// the step's staging writes folded in. Replaces, besides apply_rope on q
// and k (kubeflow_tpu/models/llama.py:278-279), the two
// dynamic_update_slice_in_dim writes of stage_key and stage_value
// (:410-413) that XLA fuses into the same jitted step: one launch rotates
// q into its output, rotates k straight into column ``step`` of
// stage_key [B, C, Hkv, D] and copies v into the same column of
// stage_value. At a decode step's rows ([8, 1, 32/8, 128]: 1 MB of
// tables read, 64 KB of activations) the launch is latency, not bytes
// (bound 0.05 us): each thread issues the position's load and its two
// 16-byte loads of x before it uses any of them, then the two table loads
// that depend on the position; no shared memory, no barrier. 128-thread
// blocks: a token's 32 + 8 + 8 heads are 384 threads (whole warps, three
// blocks), so 8 rows make 24 blocks and 48 rows 144.

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

// ---- staged decode ----------------------------------------------------------

constexpr int kStageThreads = 128;

struct StageParams {
  const void* x[3];          // q, k, v of the step's token: [B, H / G, G, D] views
  long long sb[3], sh[3], sg[3];
  int G[3];
  int Hn[3];                 // q's heads, then k's and v's (Hkv each)
  void* qo;                  // [B, Hq, D] contiguous
  void* stage[2];            // stage_key, stage_value [B, C, Hkv, D]
  long long tb[2], tc[2], th[2];
  int step;                  // the staging column written
  int D;
  const void* pos;           // [B] at stride pb
  long long pb;
  const float* cos;
  const float* sin;
  int L;
};

// Eight consecutive elements of T as raw 16-byte words (one in bf16, two
// in f32), loaded through the read-only path.
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i) {
    r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_raw8(T* p, const Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i) {
    reinterpret_cast<uint4*>(p)[i] = r.w[i];
  }
}

__device__ __forceinline__ void unpack_raw8(const Raw8<__nv_bfloat16>& r, float v[8]) {
  unpack2(r.w[0].x, v[0], v[1]);
  unpack2(r.w[0].y, v[2], v[3]);
  unpack2(r.w[0].z, v[4], v[5]);
  unpack2(r.w[0].w, v[6], v[7]);
}

__device__ __forceinline__ void unpack_raw8(const Raw8<float>& r, float v[8]) {
  v[0] = __uint_as_float(r.w[0].x); v[1] = __uint_as_float(r.w[0].y);
  v[2] = __uint_as_float(r.w[0].z); v[3] = __uint_as_float(r.w[0].w);
  v[4] = __uint_as_float(r.w[1].x); v[5] = __uint_as_float(r.w[1].y);
  v[6] = __uint_as_float(r.w[1].z); v[7] = __uint_as_float(r.w[1].w);
}

// Thread t: 8 pairs (chunk) of head h of row b; heads are q's, then k's,
// then v's. The operands are picked with constant indices (no indexing of
// the parameter space by a register).
template <typename T, typename P>
__global__ void __launch_bounds__(kStageThreads) rope_stage_kernel(const StageParams p, int items) {
  const int t = blockIdx.x * kStageThreads + threadIdx.x;
  if (t >= items) return;
  const int half = p.D / 2;
  const int per_head = half / 8;
  const int heads = p.Hn[0] + p.Hn[1] + p.Hn[2];
  const int chunk = t % per_head;
  const int rest = t / per_head;
  const int b = rest / heads;
  int h = rest % heads;
  const int which = h < p.Hn[0] ? 0 : (h < p.Hn[0] + p.Hn[1] ? 1 : 2);
  h -= which == 0 ? 0 : (which == 1 ? p.Hn[0] : p.Hn[0] + p.Hn[1]);
  const void* xw = which == 0 ? p.x[0] : (which == 1 ? p.x[1] : p.x[2]);
  const long long sb = which == 0 ? p.sb[0] : (which == 1 ? p.sb[1] : p.sb[2]);
  const long long sh = which == 0 ? p.sh[0] : (which == 1 ? p.sh[1] : p.sh[2]);
  const long long sg = which == 0 ? p.sg[0] : (which == 1 ? p.sg[1] : p.sg[2]);
  const int G = which == 0 ? p.G[0] : (which == 1 ? p.G[1] : p.G[2]);

  // The independent loads first: the position, then both halves of x.
  const long long raw_pos = static_cast<long long>(__ldg(static_cast<const P*>(p.pos) + b * p.pb));
  const T* src = static_cast<const T*>(xw) + b * sb + (h / G) * sh + (h % G) * sg + chunk * 8;
  const Raw8<T> r1 = load_raw8(src);
  const Raw8<T> r2 = load_raw8(src + half);
  if (which == 2) {        // v: copied into its staging column as it is
    T* dst = static_cast<T*>(p.stage[1]) + b * p.tb[1] + p.step * p.tc[1] + h * p.th[1] +
             chunk * 8;
    store_raw8(dst, r1);
    store_raw8(dst + half, r2);
    return;
  }
  const long long pos = raw_pos < 0 ? 0 : (raw_pos >= p.L ? p.L - 1 : raw_pos);
  float c[8], sn[8], x1[8], x2[8], o1[8], o2[8];
  load8(p.cos + pos * half + chunk * 8, c);
  load8(p.sin + pos * half + chunk * 8, sn);
  unpack_raw8(r1, x1);
  unpack_raw8(r2, x2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o1[j] = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
    o2[j] = __fadd_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], sn[j]));
  }
  T* dst = which == 0
               ? static_cast<T*>(p.qo) + (static_cast<long long>(b) * p.Hn[0] + h) * p.D + chunk * 8
               : static_cast<T*>(p.stage[0]) + b * p.tb[0] + p.step * p.tc[0] + h * p.th[0] +
                     chunk * 8;
  store8(dst, o1);
  store8(dst + half, o2);
}

template <typename T, typename P>
cudaError_t launch_stage(const StageParams& p, int B, cudaStream_t st) {
  const long long items =
      static_cast<long long>(B) * (p.Hn[0] + p.Hn[1] + p.Hn[2]) * (p.D / 16);
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((items + kStageThreads - 1) / kStageThreads);
  rope_stage_kernel<T, P><<<blocks, kStageThreads, 0, st>>>(p, static_cast<int>(items));
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

// A staged decode step's RoPE and staging writes in one launch: q (Hq
// heads) rotated into qo [B, Hq, D] (contiguous), k (Hkv heads) rotated
// into column ``step`` of stage_key and v copied into column ``step`` of
// stage_value, both [B, C, Hkv, D]. q, k and v hold one token a row, as
// [B, H / G, G, D] views: ``strides`` 9 values in elements, over B, head
// group and head within the group, for q, k, v; qg, kg, vg their group
// sizes. ``stage_strides`` 6 values, over B, C and the head, for
// stage_key then stage_value (D contiguous). dtype 0 = f32, 1 = bf16 (q,
// k, v, qo and both staging tensors alike; every row 16-byte aligned).
// positions int32 (pos_int64 = 0) or int64, one a row at stride pb; cos,
// sin [L, D/2] f32 contiguous; D a multiple of 16; 0 <= step < C. Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int kftpu_rope_stage(int dtype, int pos_int64, const void* q, const void* k,
                                const void* v, void* qo, void* stage_key, void* stage_value,
                                int B, int Hq, int Hkv, int D, const long long* strides, int qg,
                                int kg, int vg, const long long* stage_strides, int C, int step,
                                const void* positions, long long pb, const void* cos,
                                const void* sin, int L, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || B < 1 || Hq < 1 || Hkv < 1 || D < 16 ||
      D % 16 != 0 || L < 1 || C < 1 || step < 0 || step >= C || strides == nullptr ||
      stage_strides == nullptr || qg < 1 || kg < 1 || vg < 1 || Hq % qg != 0 ||
      Hkv % kg != 0 || Hkv % vg != 0 || q == nullptr || k == nullptr || v == nullptr ||
      qo == nullptr || stage_key == nullptr || stage_value == nullptr) {
    return cudaErrorInvalidValue;
  }
  StageParams p;
  const void* xs[3] = {q, k, v};
  const int gs[3] = {qg, kg, vg};
  const int hs[3] = {Hq, Hkv, Hkv};
  for (int i = 0; i < 3; ++i) {
    p.x[i] = xs[i];
    p.sb[i] = strides[3 * i];
    p.sh[i] = strides[3 * i + 1];
    p.sg[i] = strides[3 * i + 2];
    p.G[i] = gs[i];
    p.Hn[i] = hs[i];
  }
  p.qo = qo;
  p.stage[0] = stage_key;
  p.stage[1] = stage_value;
  for (int i = 0; i < 2; ++i) {
    p.tb[i] = stage_strides[3 * i];
    p.tc[i] = stage_strides[3 * i + 1];
    p.th[i] = stage_strides[3 * i + 2];
  }
  p.step = step;
  p.D = D;
  p.pos = positions;
  p.pb = pb;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.L = L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return pos_int64 ? launch_stage<__nv_bfloat16, long long>(p, B, st)
                     : launch_stage<__nv_bfloat16, int>(p, B, st);
  }
  return pos_int64 ? launch_stage<float, long long>(p, B, st) : launch_stage<float, int>(p, B, st);
}
