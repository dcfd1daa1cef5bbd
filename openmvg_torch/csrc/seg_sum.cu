// Kernel K2: deterministic segment sums for the bundle adjuster's
// camera-side reductions, one launch a call, for sm_90a.
//
// Replaces openmvg_tpu/ops/pallas_segsum.py::seg_sum_mxu (Pallas body
// `_kernel`) and, with it, the J-products its callers formed in device
// memory before each call (reference callers openmvg_tpu/sfm/ba.py
// `_seg_sum`, `_block_outer_seg`, `_camera_rmatvec`).  Three entry points:
//
//   omt_seg_sum_*      out[s] = sum of vals[i] over the rows i with
//                      ids[i] == s (vals (O, k), 1 <= k <= 64); the point
//                      sums of a problem without a group table.
//   omt_camera_sums_*  both camera halves of one bundle-adjustment product
//                      in one launch, formed in registers from the Jacobian
//                      blocks Jp (O, 2, 6) and Ji (O, 2, 8):
//                        mode 0 (J^T u):  gp[s] = sum Jp_o^T u_o  (P, 6)
//                                         gi[s] = sum Ji_o^T u_o  (I, 8)
//                        mode 1 (J^T J):  Hp[s] = sum Jp_o^T Jp_o (P, 6, 6)
//                                         Hi[s] = sum Ji_o^T Ji_o (I, 8, 8)
//                      J^T J sums the upper triangle (21 and 36 values)
//                      and mirrors it when writing, so it is symmetric bit
//                      for bit.
//
// Rows whose id lies outside [0, num) add nothing.  The TPU kernel
// multiplied a one-hot (rows, num) tile into the payload on the matrix
// unit, a workaround for row-serial scatter on the TPU; on Hopper that is
// num times the work, so it is not carried over.
//
// Determinism without float atomics.  A plan (ops/seg_sum.py::
// seg_sum_plan, once per set of ids: they are fixed across the LM loop)
// sorts the valid rows by segment (`perm`) and cuts each segment's run into
// chunks of at most 1,024 rows (`chunk_start/end`, `chunk_seg`, and
// `seg_chunk_off`, each segment's first chunk); `empty` lists the segments
// without a row.  One block of 256 threads sums one chunk in a fixed order
// (each thread its rows start + t, + 256, ... in turn, then a fixed
// shuffle tree in each warp and the warps in warp order).  A segment of one
// chunk writes its output directly.  Otherwise the block writes its chunk
// sums to `partial`, fences (__threadfence) and adds one to its segment's
// int32 arrival counter; the block that arrives last adds the segment's
// partials in an order fixed by the chunk count alone (one warp a column:
// lane l adds chunks l, l + 32, ... in turn, then the same shuffle tree)
// and writes the output.  This is
// the threadfence-reduction pattern: only the integer counter is atomic, so
// every output is one fixed sequence of additions and two launches are
// bitwise equal.  Blocks past the chunks write zeros to the empty
// segments, so every output element is written by this one launch.
//
// The counters live with the plan, zero when it is built, and the folding
// block sets its counter back to 0.  That costs no extra operation on the
// stream (the host-bound bundle adjuster pays for every one), and a launch
// that fails leaves no half-counted state behind that a later launch could
// see: a refused launch never runs, and a fault inside a kernel ends the
// CUDA context with the plan in it.  The wrappers launch on the
// current stream; one plan must not serve two streams at once, nor both
// halves of one camera launch (the wrapper refuses that).
//
// Loads.  Jacobian rows are 48 B (pose) and 64 B (intrinsic) in float32,
// 96 B and 128 B in float64, 16-B aligned (the wrapper checks): each is
// read as 16-byte vectors, neighbouring threads on neighbouring entries of
// perm.  The gather through perm is where the kernel reads more than its
// bound counts: a scattered 48-B pose row spans two 32-B sectors (64 B
// read) and its 8-B u entry one sector (32 B read); an intrinsic row is
// exactly two sectors, and with one shared intrinsic its rows are read in
// order.
//
// Bound: bytes.  J^T u must read Jp, Ji, u and both id streams once
// (O * 128 B in float32) and write (P, 6) and (I, 8); J^T J reads the blocks
// and ids (O * 120 B).  At the main path's final bundle adjustment (about
// 330,000 rows) that is about 13 us at 3.35 TB/s; the card time is in
// PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/seg_sum.py::build), loaded with ctypes.

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
// generic segment sum
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const T* __restrict__ vals, Plan pl, int k, T* __restrict__ partial,
               T* __restrict__ out) {
  __shared__ T lane_sum[kThreads];
  __shared__ T val_sh[kMaxK];
  const int j = blockIdx.x;
  if (j >= pl.n_chunks) {
    zero_empty(pl, j - pl.n_chunks, k, out);
    return;
  }
  // thread t owns column t % k of row lane t / k; lanes take rows in turn
  const int lanes = kThreads / k;
  const int c = threadIdx.x % k;
  const int lane = threadIdx.x / k;
  T acc = T(0);
  if (lane < lanes) {
    const int e = pl.end[j];
    for (int i = pl.start[j] + lane; i < e; i += lanes)
      acc += vals[static_cast<int64_t>(pl.perm[i]) * k + c];
  }
  lane_sum[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < k) {
    T sum = T(0);
    for (int l = 0; l < lanes; ++l) sum += lane_sum[l * k + threadIdx.x];
    val_sh[threadIdx.x] = sum;
  }
  __syncthreads();
  finish_chunk(val_sh, k, j, pl, partial,
               [&](int s, int cc, T v) { out[static_cast<int64_t>(s) * k + cc] = v; });
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

// Block ranges: pose chunks, intrinsic chunks, pose zero blocks, intrinsic
// zero blocks.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
camera_sums_kernel(const T* __restrict__ jp, const T* __restrict__ ji, const T* __restrict__ u,
                   Plan pp, Plan pi, T* __restrict__ part_p, T* __restrict__ part_i,
                   T* __restrict__ out_p, T* __restrict__ out_i) {
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

bool plan_ok(const Plan& p) {
  return p.num >= 0 && p.n_chunks >= 0 && p.n_empty >= 0 && p.n_empty <= p.num;
}

Plan make_plan(const int32_t* perm, const int32_t* start, const int32_t* end,
               const int32_t* seg, const int32_t* off, const int32_t* empty, int32_t* counters,
               int n_chunks, int n_empty, int num) {
  return Plan{perm, start, end, seg, off, empty, counters, n_chunks, n_empty, num};
}

template <typename T>
int launch_seg_sum(const T* vals, Plan pl, int k, T* partial, T* out, void* stream) {
  if (k < 1 || k > kMaxK || !plan_ok(pl)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = pl.n_chunks + empty_blocks(pl.n_empty);
  if (blocks == 0) return 0;
  seg_sum_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, pl, k, partial, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_camera(int mode, const T* jp, const T* ji, const T* u, Plan pp, Plan pi, T* part_p,
                  T* part_i, T* out_p, T* out_i, void* stream) {
  if ((mode != 0 && mode != 1) || !plan_ok(pp) || !plan_ok(pi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = pp.n_chunks + pi.n_chunks + empty_blocks(pp.n_empty) +
                     empty_blocks(pi.n_empty);
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    camera_sums_kernel<T, 0><<<blocks, kThreads, 0, st>>>(jp, ji, u, pp, pi, part_p, part_i,
                                                          out_p, out_i);
  else
    camera_sums_kernel<T, 1><<<blocks, kThreads, 0, st>>>(jp, ji, u, pp, pi, part_p, part_i,
                                                          out_p, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plan arguments, in this order, for each plan: perm (n_valid,), chunk_start,
// chunk_end, chunk_seg (n_chunks,), seg_chunk_off (num + 1,), empty
// (n_empty,), counters (num,), then n_chunks, n_empty, num.
#define OMT_PLAN_ARGS(p)                                                              \
  const int32_t *p##_perm, const int32_t *p##_start, const int32_t *p##_end,          \
      const int32_t *p##_seg, const int32_t *p##_off, const int32_t *p##_empty,       \
      int32_t *p##_counters, int p##_n_chunks, int p##_n_empty, int p##_num
#define OMT_PLAN(p)                                                                   \
  make_plan(p##_perm, p##_start, p##_end, p##_seg, p##_off, p##_empty, p##_counters, \
            p##_n_chunks, p##_n_empty, p##_num)

extern "C" {

// vals (rows, k) row-major; partial (max(n_chunks, 1), k) scratch; out
// (num, k).  One launch on `stream` (none when num == 0); returns
// cudaGetLastError().
int omt_seg_sum_f32(const float* vals, OMT_PLAN_ARGS(a), int k, float* partial, float* out,
                    void* stream) {
  return launch_seg_sum<float>(vals, OMT_PLAN(a), k, partial, out, stream);
}

int omt_seg_sum_f64(const double* vals, OMT_PLAN_ARGS(a), int k, double* partial,
                    double* out, void* stream) {
  return launch_seg_sum<double>(vals, OMT_PLAN(a), k, partial, out, stream);
}

// mode 0: u (O, 2), out_p (P, 6), out_i (I, 8), part_p (., 6), part_i (., 8);
// mode 1: u unused, out_p (P, 6, 6), out_i (I, 8, 8), part_p (., 21),
// part_i (., 36).  jp (O, 2, 6), ji (O, 2, 8) row-major, 16-byte aligned.
// One launch on `stream`; returns cudaGetLastError().
int omt_camera_sums_f32(int mode, const float* jp, const float* ji, const float* u,
                        OMT_PLAN_ARGS(p), OMT_PLAN_ARGS(i), float* part_p, float* part_i,
                        float* out_p, float* out_i, void* stream) {
  return launch_camera<float>(mode, jp, ji, u, OMT_PLAN(p), OMT_PLAN(i), part_p, part_i, out_p,
                              out_i, stream);
}

int omt_camera_sums_f64(int mode, const double* jp, const double* ji, const double* u,
                        OMT_PLAN_ARGS(p), OMT_PLAN_ARGS(i), double* part_p, double* part_i,
                        double* out_p, double* out_i, void* stream) {
  return launch_camera<double>(mode, jp, ji, u, OMT_PLAN(p), OMT_PLAN(i), part_p, part_i,
                               out_p, out_i, stream);
}

}  // extern "C"
