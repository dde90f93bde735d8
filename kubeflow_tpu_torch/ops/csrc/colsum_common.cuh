// Column sums over the rows of a [rows, C] activation without atomics, for
// the kernels that reduce over rows (batch_norm.cu's statistics and
// gradients, gelu.cu's bias gradient, layer_norm.cu's scale and bias
// gradients): per-block partial sums written to partial[q, block, C], then
// one fixed-order sum of the partials of each column (finish_sums), so two
// calls are bitwise equal. The block's lanes and the partials are added
// with a compensated (Kahan) sum (kahan_add; batch_norm.cu's statistics use
// it for each thread's rows too): a column of a 3.2M-row activation then
// sums to within ~1e-7 of its f64 value, where plain f32 adds in these
// orders were seen 2.4e-6 off.
//
// The row-run layout (tile_of): block b of P takes a contiguous run of rows
// and a tile of up to kThreads chunks of V channels (blockIdx.y); V = 8 moves
// 16 bytes a thread, V = 1 takes any C. Thread t takes chunk t % width of
// the tile and row lane t / width; the rp = kThreads / width lanes step
// through the run rp rows apart.

#pragma once

#include "fused_common.cuh"

namespace kftpu_colsum {

using namespace kftpu_fused;

constexpr int kThreads = 256;
constexpr int kFinishCols = 32;
constexpr int kFinishLanes = 32;

template <typename T, int V>
__device__ __forceinline__ void loadv(const T* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
    v[0] = load1(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void storev(T* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    store8(p, v);
  } else {
    store1(p, v[0]);
  }
}

// s + c is a running sum; adds v (compensated: Kahan's). The explicit
// roundings keep the compiler from contracting or reassociating it.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// V consecutive values of a [C] vector at column c, as f32.
template <typename T, int V>
__device__ __forceinline__ void loadc(const T* p, int c, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = load1(p + c + j);
}

struct Tile {
  int width;          // chunks in the tile
  int rp;             // row lanes
  int col;            // this thread's first column
  int lane;           // this thread's row lane
  bool live;          // lane < rp
  long long r0, r1;   // the block's rows
};

template <int V>
__device__ __forceinline__ Tile tile_of(long long rows, int C, long long per) {
  Tile t;
  const int nc = C / V;
  const int c0 = blockIdx.y * kThreads;
  t.width = min(kThreads, nc - c0);
  t.rp = kThreads / t.width;
  t.col = (c0 + static_cast<int>(threadIdx.x) % t.width) * V;
  t.lane = static_cast<int>(threadIdx.x) / t.width;
  t.live = t.lane < t.rp;
  t.r0 = static_cast<long long>(blockIdx.x) * per;
  t.r1 = min(rows, t.r0 + per);
  return t;
}

// The grid of the row-run kernels for P row runs, and the rows a run.
template <int V>
inline dim3 grid_of(int C, int P) {
  const int nc = C / V;
  return dim3(static_cast<unsigned>(P), static_cast<unsigned>((nc + kThreads - 1) / kThreads));
}

inline long long per_run(long long rows, int P) { return (rows + P - 1) / P; }

// Adds the block's row lanes of each of the Q sums acc[q] in lane order and
// writes them to partial[q, blockIdx.x, the tile's columns] ([Q, P, C] f32).
// Every thread of the block must call it.
template <int V, int Q>
__device__ __forceinline__ void write_partials(const Tile& t, const float (&acc)[Q][V],
                                               float* __restrict__ partial, int C) {
  __shared__ float red[Q][kThreads * V];
  const int width = t.width * V;
  const int local = (static_cast<int>(threadIdx.x) % t.width) * V;
  if (t.live) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int j = 0; j < V; ++j) red[q][t.lane * width + local + j] = acc[q][j];
    }
  }
  __syncthreads();
  const size_t P = gridDim.x;
  for (int e = threadIdx.x; e < width; e += kThreads) {
    const size_t col = static_cast<size_t>(blockIdx.y) * kThreads * V + e;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float s = 0.f, c = 0.f;
      for (int l = 0; l < t.rp; ++l) kahan_add(s, c, red[q][l * width + e]);
      partial[(q * P + blockIdx.x) * static_cast<size_t>(C) + col] = s;
    }
  }
}

// The fixed-order sum of the P partials of column c = blockIdx.x *
// kFinishCols + threadIdx.x, in a block of kFinishCols x kFinishLanes
// threads: lane l (threadIdx.y) adds rows l, l + kFinishLanes, ..., then
// lane 0 adds the lanes in order. Returns c in lane 0 (the totals in tot),
// -1 in every other thread and past C.
template <int Q>
__device__ __forceinline__ int finish_sums(const float* __restrict__ partial, int P, int C,
                                           float (&tot)[Q]) {
  __shared__ float red[Q][kFinishLanes][kFinishCols + 1];
  const int c = blockIdx.x * kFinishCols + threadIdx.x;
  const int lane = threadIdx.y;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float a = 0.f, comp = 0.f;
    if (c < C) {
      for (int i = lane; i < P; i += kFinishLanes) {
        kahan_add(a, comp, partial[(static_cast<size_t>(q) * P + i) * C + c]);
      }
    }
    red[q][lane][threadIdx.x] = a;
  }
  __syncthreads();
  if (lane != 0 || c >= C) return -1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float s = 0.f, comp = 0.f;
    for (int l = 0; l < kFinishLanes; ++l) kahan_add(s, comp, red[q][l][threadIdx.x]);
    tot[q] = s;
  }
  return c;
}

inline dim3 finish_grid(int C) { return dim3((C + kFinishCols - 1) / kFinishCols); }
inline dim3 finish_block() { return dim3(kFinishCols, kFinishLanes); }

}  // namespace kftpu_colsum
