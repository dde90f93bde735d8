// The optimizer step over every parameter tensor in two launches, for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes);
// see kubeflow_tpu_torch/ops/optimizer.py.
//
// Replaces the XLA fusion of the JAX trainer's optax chain,
// kubeflow_tpu/train/trainer.py::TrainConfig.make_optimizer (:132-197):
// _f32_moments(chain(clip_by_global_norm, adamw | lion | trace + decoupled
// decay)), applied by optax.apply_updates (:487-490) inside the jitted step.
// There is no Pallas kernel behind it.
//
// Function. The tensors are cut into chunks of kChunk elements, tensor by
// tensor (the chunk table: tensor t owns chunks first[t] .. first[t+1]-1).
// (a) kftpu_global_norm: partial[c] = sum of g^2 over chunk c in f32, then
//     norm = sqrt(sum of the partials in chunk order), written to a device
//     scalar.
// (b) kftpu_optimizer_update, in place, reading that norm: g is scaled by
//     (g / norm) * max_norm when norm >= max_norm, then adamw, lion or sgd
//     (nesterov trace) with decoupled weight decay, each step one f32
//     operation rounded to nearest in the order of the plain version
//     (kubeflow_tpu_torch/ops/optimizer.py::update_reference): a product
//     with the moment held in bf16 is rounded to bf16 where the plain
//     version's tensor op rounds it; p + u is formed in f32 and rounded once
//     to p's dtype; mu is stored in its own dtype, nu (or the trace) in f32.
//     Given the same norm, kernel and plain version agree bitwise.
//
// Bound on this card: bytes. The norm reads every gradient once; the update
// reads p, g, mu and nu and writes p, mu and nu: 2 + 18 bytes a parameter
// with bf16 params, grads and mu and f32 nu, 13.9 GB and 4.2 ms for the
// 697.4M-parameter model at 3.35 TB/s.
//
// Design: one block of 256 threads a chunk; a block finds its tensor by a
// binary search of the table's chunk starts and walks its chunk eight
// elements a thread (16-byte loads for bf16, two for f32). The table (per
// tensor: pointers, element count, first chunk, dtypes) lives on the device
// and is rebuilt by the wrapper only when the parameter set changes; the
// gradients, new tensors every step, come as a second array of pointers.
// Dtypes may differ between tensors (f32 grads under accumulation); the
// branch on them is uniform across a block.

#include <math.h>

#include "fused_common.cuh"

namespace {

using namespace kftpu_fused;

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;
constexpr long long kChunk = 65536;
// The table's int64 fields a tensor (the gradient's pointer is in grads[t]).
constexpr int kFields = 6;
enum Field { kP = 0, kM = 1, kV = 2, kNumel = 3, kFirst = 4, kDtypes = 5 };

enum Kind { kAdamW = 0, kLion = 1, kSgd = 2 };

struct Hyper {
  float max_norm;        // clip threshold
  float c1, b1, c2, b2;  // 1 - b1, b1, 1 - b2, b2 (f32 casts of the host's values)
  float inv_bc1, inv_bc2;
  float eps, wd, neg_lr;
};

// The tensor that owns chunk c: the last t with first[t] <= c.
__device__ __forceinline__ int find_tensor(const long long* table, int T, long long c) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kFields + kFirst] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename G>
__device__ __forceinline__ float chunk_sumsq(const G* g, long long start, long long n) {
  float s = 0.f;
  const long long full = n / 8 * 8;
  for (long long i = threadIdx.x * 8LL; i < full; i += kThreads * 8LL) {
    float v[8];
    load8(g + start + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j] * v[j];
  }
  for (long long i = full + threadIdx.x; i < n; i += kThreads) {
    const float v = load1(g + start + i);
    s += v * v;
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    norm_partial(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
                 float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  const long long c = blockIdx.x;
  const int t = find_tensor(table, T, c);
  const long long* e = table + t * kFields;
  const long long start = (c - e[kFirst]) * kChunk;
  const long long n = min(kChunk, e[kNumel] - start);
  const int gdt = static_cast<int>((e[kDtypes] >> 2) & 3);
  const float s = gdt == kBF16
                      ? chunk_sumsq(reinterpret_cast<const __nv_bfloat16*>(grads[t]), start, n)
                      : chunk_sumsq(reinterpret_cast<const float*>(grads[t]), start, n);
  const float total = block_sum<kThreads>(s, red);
  if (threadIdx.x == 0) partial[c] = total;
}

__global__ void __launch_bounds__(kSumThreads)
    norm_final(const float* __restrict__ partial, long long chunks, float* __restrict__ norm) {
  __shared__ float red[kSumThreads / 32];
  float s = 0.f;
  for (long long c = threadIdx.x; c < chunks; c += kSumThreads) s += partial[c];
  const float total = block_sum<kSumThreads>(s, red);
  if (threadIdx.x == 0) norm[0] = sqrtf(total);
}

// One element's update; m and v are the stored moments as f32, rewritten.
template <int kKind>
__device__ __forceinline__ float update1(float p, float g, float& m, float& v, int mdt,
                                         const Hyper& h, bool clip, float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  float u;
  if (kKind == kAdamW) {
    const float mu = __fadd_rn(__fmul_rn(h.c1, g), round_to(__fmul_rn(h.b1, m), mdt));
    v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.c2, __fmul_rn(g, g)));
    u = __fdiv_rn(__fmul_rn(mu, h.inv_bc1),
                  __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps));
    m = round_to(mu, mdt);
  } else if (kKind == kLion) {
    const float d = __fadd_rn(__fmul_rn(h.c1, g), round_to(__fmul_rn(h.b1, m), mdt));
    u = static_cast<float>((0.f < d) - (d < 0.f));
    m = round_to(__fadd_rn(__fmul_rn(h.c2, g), round_to(__fmul_rn(h.b2, m), mdt)), mdt);
  } else {
    m = __fadd_rn(g, __fmul_rn(h.b1, m));
    u = __fadd_rn(g, __fmul_rn(h.b1, m));
  }
  u = __fmul_rn(__fadd_rn(u, __fmul_rn(h.wd, p)), h.neg_lr);
  return __fadd_rn(p, u);
}

template <typename P, typename G, typename M, int kKind>
__device__ __forceinline__ void update_chunk(const long long* e, long long gptr, long long start,
                                             long long n, const Hyper& h, bool clip,
                                             float norm) {
  P* p = reinterpret_cast<P*>(e[kP]) + start;
  const G* g = reinterpret_cast<const G*>(gptr) + start;
  M* m = reinterpret_cast<M*>(e[kM]) + start;
  float* v = kKind == kAdamW ? reinterpret_cast<float*>(e[kV]) + start : nullptr;
  const int mdt = sizeof(M) == 2 ? kBF16 : kF32;
  const long long full = n / 8 * 8;
  for (long long i = threadIdx.x * 8LL; i < full; i += kThreads * 8LL) {
    float pv[8], gv[8], mv[8], vv[8] = {};
    load8(p + i, pv);
    load8(g + i, gv);
    load8(m + i, mv);
    if (kKind == kAdamW) load8(v + i, vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pv[j] = update1<kKind>(pv[j], gv[j], mv[j], vv[j], mdt, h, clip, norm);
    }
    store8(p + i, pv);
    store8(m + i, mv);
    if (kKind == kAdamW) store8(v + i, vv);
  }
  for (long long i = full + threadIdx.x; i < n; i += kThreads) {
    float mv = load1(m + i), vv = kKind == kAdamW ? v[i] : 0.f;
    const float pv = update1<kKind>(load1(p + i), load1(g + i), mv, vv, mdt, h, clip, norm);
    store1(p + i, pv);
    store1(m + i, mv);
    if (kKind == kAdamW) v[i] = vv;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    update(const long long* __restrict__ table, const long long* __restrict__ grads, int T,
           const float* __restrict__ norm_ptr, Hyper h) {
  const long long c = blockIdx.x;
  const int t = find_tensor(table, T, c);
  const long long* e = table + t * kFields;
  const long long start = (c - e[kFirst]) * kChunk;
  const long long n = min(kChunk, e[kNumel] - start);
  const float norm = norm_ptr[0];
  const bool clip = norm >= h.max_norm;
  const int dt = static_cast<int>(e[kDtypes]);
  const int pdt = dt & 3, gdt = (dt >> 2) & 3, mdt = (dt >> 4) & 3;
  // Eight dtype combinations; p, g and mu each f32 or bf16.
  using B = __nv_bfloat16;
  switch (pdt * 4 + gdt * 2 + mdt) {
    case 0: update_chunk<float, float, float, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 1: update_chunk<float, float, B, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 2: update_chunk<float, B, float, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 3: update_chunk<float, B, B, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 4: update_chunk<B, float, float, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 5: update_chunk<B, float, B, kKind>(e, grads[t], start, n, h, clip, norm); break;
    case 6: update_chunk<B, B, float, kKind>(e, grads[t], start, n, h, clip, norm); break;
    default: update_chunk<B, B, B, kKind>(e, grads[t], start, n, h, clip, norm); break;
  }
}

bool valid_grid(long long chunks, int T) {
  return T > 0 && chunks > 0 && chunks < (1LL << 31);
}

}  // namespace

// Elements a chunk of the table holds (the wrapper checks its CHUNK).
extern "C" long long kftpu_optimizer_chunk() { return kChunk; }

// norm [1] f32 = sqrt(sum of g^2) over the table's T tensors (``chunks``
// chunks in all; ``partial`` [chunks] f32 scratch). ``table``: device int64
// [T, 6] (see kFields; dtypes packed p | g << 2 | mu << 4, 0 = f32,
// 1 = bf16); ``grads``: device int64 [T], the gradients' pointers; every
// tensor contiguous and 16-byte aligned. Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int kftpu_global_norm(const void* table, const void* grads, int T, long long chunks,
                                 void* partial, void* norm, void* stream) {
  if (!valid_grid(chunks, T)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  norm_partial<<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(
      static_cast<const long long*>(table), static_cast<const long long*>(grads), T, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_final<<<1, kSumThreads, 0, st>>>(part, chunks, static_cast<float*>(norm));
  return cudaGetLastError();
}

// One optimizer step in place over the table's tensors (``kind`` 0 adamw,
// 1 lion, 2 sgd: mu is the trace, f32), clipped by the device norm [1] f32.
// The scalars are the plain version's f32 casts (see Hyper).
extern "C" int kftpu_optimizer_update(int kind, const void* table, const void* grads, int T,
                                      long long chunks, const void* norm, float max_norm,
                                      float c1, float b1,
                                      float c2, float b2, float inv_bc1, float inv_bc2, float eps,
                                      float wd, float neg_lr, void* stream) {
  if (!valid_grid(chunks, T) || kind < kAdamW || kind > kSgd) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{max_norm, c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd, neg_lr};
  const long long* tab = static_cast<const long long*>(table);
  const long long* gp = static_cast<const long long*>(grads);
  const float* nrm = static_cast<const float*>(norm);
  const unsigned grid = static_cast<unsigned>(chunks);
  if (kind == kAdamW) {
    update<kAdamW><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, h);
  } else if (kind == kLion) {
    update<kLion><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, h);
  } else {
    update<kSgd><<<grid, kThreads, 0, st>>>(tab, gp, T, nrm, h);
  }
  return cudaGetLastError();
}
