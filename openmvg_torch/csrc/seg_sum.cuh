// Kernel K2's device code, shared by openmvg_torch/csrc/seg_sum.cu (K2's
// own entry points) and openmvg_torch/csrc/smatvec.cu (K3, whose second
// launch is K2's camera sums on its e buffer): the plan, the fixed-order
// block sums, the arrival-counter fold and the fused camera sums.  The
// design and its determinism argument are in the note of seg_sum.cu.
// utils/build.py hashes every csrc/*.cuh into each library's name, so a
// change here rebuilds both.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kEmptyPerBlock = kWarps;  // one warp zero-fills one empty segment

struct Plan {
  const int32_t* perm;
  const int32_t* start;
  const int32_t* end;
  const int32_t* seg;    // segment of each chunk
  const int32_t* off;    // (num + 1,) first chunk of each segment
  const int32_t* empty;  // segments without a row
  int32_t* counters;     // (num,) arrival counters, 0 between launches
  int n_chunks, n_empty, num;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block sum of N per-thread values in a fixed order: the shuffle tree in
// each warp, then the warp sums in warp order.  The result lands in
// out_sh[0..N) (shared); every thread must call it.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&acc)[N], T (*red)[N], T* out_sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const T v = warp_sum(acc[c]);
    if (lane == 0) red[w][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][threadIdx.x];
    out_sh[threadIdx.x] = s;
  }
  __syncthreads();
}

// The chunk's n sums are in val_sh.  One chunk: emit them.  Otherwise store
// them as chunk j's partial, count the arrival, and let the last block of
// the segment add the partials in a fixed order and emit the sums.
// emit(s, c, value) writes output element c of segment s.
template <typename T, typename Emit>
__device__ __forceinline__ void finish_chunk(const T* val_sh, int n, int j, const Plan& pl,
                                             T* __restrict__ partial, Emit emit) {
  __shared__ int is_last;
  const int s = pl.seg[j];
  const int first = pl.off[s], nch = pl.off[s + 1] - first;
  if (nch == 1) {
    for (int c = threadIdx.x; c < n; c += kThreads) emit(s, c, val_sh[c]);
    return;
  }
  for (int c = threadIdx.x; c < n; c += kThreads)
    partial[static_cast<int64_t>(j) * n + c] = val_sh[c];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&pl.counters[s], 1) == nch - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c = w; c < n; c += kWarps) {
    T v = T(0);
    for (int i = lane; i < nch; i += 32)
      v += __ldcg(&partial[static_cast<int64_t>(first + i) * n + c]);
    v = warp_sum(v);
    if (lane == 0) emit(s, c, v);
  }
  if (threadIdx.x == 0) pl.counters[s] = 0;
}

// Blocks past the chunks: warp w of block b writes zeros over the output of
// empty segment b * kWarps + w (`width` elements a segment).
template <typename T>
__device__ __forceinline__ void zero_empty(const Plan& pl, int b, int width, T* __restrict__ out) {
  const int e = b * kEmptyPerBlock + (threadIdx.x >> 5);
  if (e >= pl.n_empty) return;
  T* o = out + static_cast<int64_t>(pl.empty[e]) * width;
  for (int c = threadIdx.x & 31; c < width; c += 32) o[c] = T(0);
}

__host__ __device__ __forceinline__ int empty_blocks(int n_empty) {
  return (n_empty + kEmptyPerBlock - 1) / kEmptyPerBlock;
}

// ---------------------------------------------------------------------------
// fused camera sums
// ---------------------------------------------------------------------------

// A row of 2K values (the two residual rows of one Jacobian block) in
// 16-byte loads.
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[N]) {
  static_assert(N % 4 == 0, "float rows load as float4");
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = q[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const double* __restrict__ p, double (&r)[N]) {
  static_assert(N % 2 == 0, "double rows load as double2");
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 v = q[i];
    r[2 * i] = v.x;
    r[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_u(const float* __restrict__ u, int64_t o, float& u0, float& u1) {
  const float2 v = reinterpret_cast<const float2*>(u)[o];
  u0 = v.x;
  u1 = v.y;
}

__device__ __forceinline__ void load_u(const double* __restrict__ u, int64_t o, double& u0,
                                       double& u1) {
  const double2 v = reinterpret_cast<const double2*>(u)[o];
  u0 = v.x;
  u1 = v.y;
}

__host__ __device__ constexpr int tri(int K) { return K * (K + 1) / 2; }

// One chunk of one half: K = 6 (pose) or 8 (intrinsic).  mode 0 sums
// J^T u (K values), mode 1 the upper triangle of J^T J (K (K + 1) / 2
// values, row-major a <= b).
template <typename T, int K, int MODE>
__device__ __forceinline__ void camera_chunk(const T* __restrict__ J, const T* __restrict__ u,
                                             const Plan& pl, int j, T* __restrict__ partial,
                                             T* __restrict__ out) {
  constexpr int N = MODE == 0 ? K : tri(K);
  __shared__ T red[kWarps][N];
  __shared__ T val_sh[N];
  T acc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = T(0);
  const int e = pl.end[j];
  for (int i = pl.start[j] + threadIdx.x; i < e; i += kThreads) {
    const int64_t o = pl.perm[i];
    T r[2 * K];
    load_row(J + o * (2 * K), r);
    if constexpr (MODE == 0) {
      T u0, u1;
      load_u(u, o, u0, u1);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += r[c] * u0 + r[K + c] * u1;
    } else {
      int t = 0;
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int b = a; b < K; ++b, ++t) acc[t] += r[a] * r[b] + r[K + a] * r[K + b];
    }
  }
  block_sum<T, N>(acc, red, val_sh);
  if constexpr (MODE == 0) {
    finish_chunk(val_sh, N, j, pl, partial,
                 [&](int s, int c, T v) { out[static_cast<int64_t>(s) * K + c] = v; });
  } else {
    finish_chunk(val_sh, N, j, pl, partial, [&](int s, int c, T v) {
      // c -> (a, b), a <= b, in the order the triangle was summed
      int a = 0, rem = c;
      while (rem >= K - a) rem -= K - a++;
      const int b = a + rem;
      T* m = out + static_cast<int64_t>(s) * K * K;
      m[a * K + b] = v;
      m[b * K + a] = v;
    });
  }
}

// The body of one block of a camera-sums launch of camera_blocks(pp, pi)
// blocks of kThreads.  Block ranges: pose chunks, intrinsic chunks, pose
// zero blocks, intrinsic zero blocks.
template <typename T, int MODE>
__device__ __forceinline__ void camera_sums_body(const T* __restrict__ jp, const T* __restrict__ ji,
                                                 const T* __restrict__ u, const Plan& pp,
                                                 const Plan& pi, T* __restrict__ part_p,
                                                 T* __restrict__ part_i, T* __restrict__ out_p,
                                                 T* __restrict__ out_i) {
  int b = blockIdx.x;
  if (b < pp.n_chunks) {
    camera_chunk<T, 6, MODE>(jp, u, pp, b, part_p, out_p);
    return;
  }
  b -= pp.n_chunks;
  if (b < pi.n_chunks) {
    camera_chunk<T, 8, MODE>(ji, u, pi, b, part_i, out_i);
    return;
  }
  b -= pi.n_chunks;
  const int zp = empty_blocks(pp.n_empty);
  if (b < zp) {
    zero_empty(pp, b, MODE == 0 ? 6 : 36, out_p);
    return;
  }
  zero_empty(pi, b - zp, MODE == 0 ? 8 : 64, out_i);
}

__host__ __device__ __forceinline__ int camera_blocks(const Plan& pp, const Plan& pi) {
  return pp.n_chunks + pi.n_chunks + empty_blocks(pp.n_empty) + empty_blocks(pi.n_empty);
}

bool plan_ok(const Plan& p) {
  return p.num >= 0 && p.n_chunks >= 0 && p.n_empty >= 0 && p.n_empty <= p.num;
}

}  // namespace
