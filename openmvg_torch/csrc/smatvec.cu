// Kernel K3: the fused S-matvec of the bundle adjuster's Schur-CG solve,
// for sm_90a.
//
// Replaces openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (Pallas
// bodies `_kernel_a` and `_kernel_b`): for the reduced camera system
// S = B - E Hpp^-1 E^T it returns the two camera halves
//
//   (sp, si) = Jc^T (u - Jx Hpp^-1 Jx^T u),   u = Jc v,  v = (vp, vi)
//
// over the point-major observation layout (each point's slots form rows
// of R consecutive slots; ops/smatvec.py and sfm/ba.py::build_pt_obs),
// everything except the O(P) terms lam D v and Hprior v, which the caller
// adds.  Per slot o: Jp (2 x 6), Ji (2 x 8), Jx (2 x 3), a pose and an
// intrinsic id.
//
// The TPU kernel expanded v and reduced the pose/intrinsic sums with
// one-hot matrix-unit products, padded pose and intrinsic counts to 128
// lanes and ran per-point vectors transposed; those were TPU layout
// workarounds and are not carried over.  What matters here is that the
// result repeats bit for bit (the adjuster is held to repeatable runs) and
// that no float atomics are used.  Four launches:
//
//   smatvec_rows    one thread per point-major row: for each of its R
//                   slots in order, u = Jp vp[pose] + Ji vi[intr] and
//                   w += Jx^T u; writes row_sums (L1, 3).
//   smatvec_points  one thread per point: adds its rows through the group
//                   table in column order (sentinels >= L1 add nothing),
//                   then y = Hpp^-1 w (L, 3).
//   smatvec_cams    runs over kernel K2's plans (ops/seg_sum.py): the
//                   valid slots sorted by pose (or intrinsic) id, cut into
//                   chunks of at most 1024.  One 256-thread block per
//                   chunk, pose chunks first, then intrinsic chunks.  Each
//                   thread recomputes u for its slots (start + t, + 256,
//                   ...), e = u - Jx y[point of the slot's row], and adds
//                   Jp^T e (6 values) or Ji^T e (8 values); the block then
//                   adds its threads in a fixed tree order into one row of
//                   per-chunk partial sums.
//   smatvec_fold    one thread per output element adds its segment's chunk
//                   partials in chunk order (K2's fold pass).
//
// Every output element is therefore one fixed sequence of operations,
// decided by the plans and the layout alone.
//
// Bound: bytes.  One call must read the slot Jacobians (34 floats a slot)
// and ids once, plus the point blocks, tables and v, and write (P, 6) and
// (I, 8): at the main path's final BA (about 330,000 slots) some 50 MB,
// about 15 us at 3.35 TB/s, against about 45 MFLOP (0.7 us at the float32
// rate outside the tensor cores).  This first version reads the slot
// Jacobians twice (pass A and pass B recompute u instead of writing it
// out), and pass A's one-thread-per-row walk does not coalesce its loads;
// its time on the card is in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/smatvec.py::build), loaded with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// u = (u0, u1) = Jp_o vp[pose_o] + Ji_o vi[intr_o]; an id outside its range
// contributes nothing.
__device__ __forceinline__ void camera_u(const float* __restrict__ jp,
                                         const float* __restrict__ ji,
                                         const int32_t* __restrict__ pose_ids,
                                         const int32_t* __restrict__ intr_ids,
                                         const float* __restrict__ vp,
                                         const float* __restrict__ vi,
                                         int n_pose, int n_intr, int64_t o,
                                         float& u0, float& u1) {
  u0 = 0.f;
  u1 = 0.f;
  const int p = pose_ids[o];
  if (p >= 0 && p < n_pose) {
    const float* a = jp + o * 12;
    const float* v = vp + static_cast<int64_t>(p) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      u0 = fmaf(a[c], v[c], u0);
      u1 = fmaf(a[6 + c], v[c], u1);
    }
  }
  const int q = intr_ids[o];
  if (q >= 0 && q < n_intr) {
    const float* b = ji + o * 16;
    const float* v = vi + static_cast<int64_t>(q) * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      u0 = fmaf(b[c], v[c], u0);
      u1 = fmaf(b[8 + c], v[c], u1);
    }
  }
}

__global__ void smatvec_rows(const float* __restrict__ jp, const float* __restrict__ ji,
                             const float* __restrict__ jx,
                             const int32_t* __restrict__ pose_ids,
                             const int32_t* __restrict__ intr_ids,
                             const float* __restrict__ vp, const float* __restrict__ vi,
                             int n_pose, int n_intr, int L1, int R,
                             float* __restrict__ row_sums) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= L1) return;
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  for (int s = 0; s < R; ++s) {
    const int64_t o = static_cast<int64_t>(r) * R + s;
    float u0, u1;
    camera_u(jp, ji, pose_ids, intr_ids, vp, vi, n_pose, n_intr, o, u0, u1);
    const float* x = jx + o * 6;
    w0 = fmaf(x[3], u1, fmaf(x[0], u0, w0));
    w1 = fmaf(x[4], u1, fmaf(x[1], u0, w1));
    w2 = fmaf(x[5], u1, fmaf(x[2], u0, w2));
  }
  row_sums[static_cast<int64_t>(r) * 3 + 0] = w0;
  row_sums[static_cast<int64_t>(r) * 3 + 1] = w1;
  row_sums[static_cast<int64_t>(r) * 3 + 2] = w2;
}

__global__ void smatvec_points(const float* __restrict__ row_sums,
                               const int32_t* __restrict__ groups, int L, int M, int L1,
                               const float* __restrict__ hpp_inv, float* __restrict__ y) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  for (int c = 0; c < M; ++c) {
    const int g = groups[static_cast<int64_t>(l) * M + c];
    if (g >= 0 && g < L1) {
      w0 += row_sums[static_cast<int64_t>(g) * 3 + 0];
      w1 += row_sums[static_cast<int64_t>(g) * 3 + 1];
      w2 += row_sums[static_cast<int64_t>(g) * 3 + 2];
    }
  }
  const float* h = hpp_inv + static_cast<int64_t>(l) * 9;
  y[static_cast<int64_t>(l) * 3 + 0] = fmaf(h[2], w2, fmaf(h[1], w1, h[0] * w0));
  y[static_cast<int64_t>(l) * 3 + 1] = fmaf(h[5], w2, fmaf(h[4], w1, h[3] * w0));
  y[static_cast<int64_t>(l) * 3 + 2] = fmaf(h[8], w2, fmaf(h[7], w1, h[6] * w0));
}

__global__ void __launch_bounds__(kThreads)
smatvec_cams(const float* __restrict__ jp, const float* __restrict__ ji,
             const float* __restrict__ jx, const int32_t* __restrict__ pose_ids,
             const int32_t* __restrict__ intr_ids, const float* __restrict__ vp,
             const float* __restrict__ vi, int n_pose, int n_intr, int R, int L,
             const int32_t* __restrict__ row_point, const float* __restrict__ y,
             const int32_t* __restrict__ perm_p, const int32_t* __restrict__ start_p,
             const int32_t* __restrict__ end_p, int n_chunks_p,
             const int32_t* __restrict__ perm_i, const int32_t* __restrict__ start_i,
             const int32_t* __restrict__ end_i, float* __restrict__ partial_p,
             float* __restrict__ partial_i) {
  __shared__ float sh[8][kThreads];
  const bool is_pose = static_cast<int>(blockIdx.x) < n_chunks_p;
  const int j = is_pose ? blockIdx.x : blockIdx.x - n_chunks_p;
  const int32_t* perm = is_pose ? perm_p : perm_i;
  const int start = is_pose ? start_p[j] : start_i[j];
  const int end = is_pose ? end_p[j] : end_i[j];
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const int64_t o = perm[i];
    float u0, u1;
    camera_u(jp, ji, pose_ids, intr_ids, vp, vi, n_pose, n_intr, o, u0, u1);
    int p = row_point[o / R];
    p = p < 0 ? 0 : (p > L - 1 ? L - 1 : p);
    const float* yy = y + static_cast<int64_t>(p) * 3;
    const float* x = jx + o * 6;
    const float e0 = u0 - fmaf(x[2], yy[2], fmaf(x[1], yy[1], x[0] * yy[0]));
    const float e1 = u1 - fmaf(x[5], yy[2], fmaf(x[4], yy[1], x[3] * yy[0]));
    if (is_pose) {
      const float* a = jp + o * 12;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] = fmaf(a[6 + c], e1, fmaf(a[c], e0, acc[c]));
    } else {
      const float* b = ji + o * 16;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(b[8 + c], e1, fmaf(b[c], e0, acc[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) sh[c][threadIdx.x] = acc[c];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s) {
#pragma unroll
      for (int c = 0; c < 8; ++c) sh[c][threadIdx.x] += sh[c][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (is_pose) {
    if (threadIdx.x < 6) partial_p[static_cast<int64_t>(j) * 6 + threadIdx.x] = sh[threadIdx.x][0];
  } else if (threadIdx.x < 8) {
    partial_i[static_cast<int64_t>(j) * 8 + threadIdx.x] = sh[threadIdx.x][0];
  }
}

__global__ void smatvec_fold(const float* __restrict__ partial_p,
                             const int32_t* __restrict__ off_p, int n_pose,
                             const float* __restrict__ partial_i,
                             const int32_t* __restrict__ off_i, int n_intr,
                             float* __restrict__ sp, float* __restrict__ si) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_sp = n_pose * 6;
  if (idx >= n_sp + n_intr * 8) return;
  const bool is_pose = idx < n_sp;
  const int k = is_pose ? 6 : 8;
  const int e = is_pose ? idx : idx - n_sp;
  const int s = e / k;
  const int c = e - s * k;
  const int32_t* off = is_pose ? off_p : off_i;
  const float* part = is_pose ? partial_p : partial_i;
  float sum = 0.f;
  for (int j = off[s]; j < off[s + 1]; ++j) sum += part[static_cast<int64_t>(j) * k + c];
  (is_pose ? sp : si)[e] = sum;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// jp (O, 12), ji (O, 16), jx (O, 6) float32 row-major, O = L1 * R;
// pose_ids / intr_ids (O,); vp (n_pose, 6), vi (n_intr, 8); hpp_inv
// (L, 3, 3); row_point (L1,); groups (L, M); K2 plans of the pose and
// intrinsic ids (perm, chunk start/end, per-segment chunk offsets);
// row_sums (L1, 3), y (L, 3), partial_p (n_chunks_p, 6) and partial_i
// (n_chunks_i, 8) scratch; sp (n_pose, 6), si (n_intr, 8) out.  Launches
// on `stream` (each launch is skipped when it has nothing to do: no rows,
// no points, no chunks, no outputs); returns cudaGetLastError().
int omt_smatvec_f32(const float* jp, const float* ji, const float* jx,
                    const int32_t* pose_ids, const int32_t* intr_ids, const float* vp,
                    const float* vi, const float* hpp_inv, const int32_t* row_point,
                    const int32_t* groups, const int32_t* perm_p, const int32_t* start_p,
                    const int32_t* end_p, const int32_t* off_p, const int32_t* perm_i,
                    const int32_t* start_i, const int32_t* end_i, const int32_t* off_i,
                    int L1, int R, int L, int M, int n_pose, int n_intr, int n_chunks_p,
                    int n_chunks_i, float* row_sums, float* y, float* partial_p,
                    float* partial_i, float* sp, float* si, void* stream) {
  if (L1 < 0 || R < 1 || L < 0 || M < 0 || n_pose < 0 || n_intr < 0 || n_chunks_p < 0 ||
      n_chunks_i < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L1 > 0)
    smatvec_rows<<<blocks(L1), kThreads, 0, st>>>(jp, ji, jx, pose_ids, intr_ids, vp, vi,
                                                  n_pose, n_intr, L1, R, row_sums);
  if (L > 0)
    smatvec_points<<<blocks(L), kThreads, 0, st>>>(row_sums, groups, L, M, L1, hpp_inv, y);
  if (n_chunks_p + n_chunks_i > 0)
    smatvec_cams<<<n_chunks_p + n_chunks_i, kThreads, 0, st>>>(
        jp, ji, jx, pose_ids, intr_ids, vp, vi, n_pose, n_intr, R, L, row_point, y, perm_p,
        start_p, end_p, n_chunks_p, perm_i, start_i, end_i, partial_p, partial_i);
  const int total = n_pose * 6 + n_intr * 8;
  if (total > 0)
    smatvec_fold<<<blocks(total), kThreads, 0, st>>>(partial_p, off_p, n_pose, partial_i,
                                                     off_i, n_intr, sp, si);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
