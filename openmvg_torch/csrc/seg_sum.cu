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
// The plan, block sums, fold and camera-sum body live in seg_sum.cuh, which
// K3 (smatvec.cu) includes for its camera launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -I csrc (see ops/seg_sum.py::build), loaded with ctypes.

#include "seg_sum.cuh"

namespace {

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

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
camera_sums_kernel(const T* __restrict__ jp, const T* __restrict__ ji, const T* __restrict__ u,
                   Plan pp, Plan pi, T* __restrict__ part_p, T* __restrict__ part_i,
                   T* __restrict__ out_p, T* __restrict__ out_i) {
  camera_sums_body<T, MODE>(jp, ji, u, pp, pi, part_p, part_i, out_p, out_i);
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
  const int blocks = camera_blocks(pp, pi);
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
