// Kernel K2: deterministic segment sum for the bundle adjuster's
// camera-side reductions, for sm_90a.
//
// Replaces openmvg_tpu/ops/pallas_segsum.py::seg_sum_mxu (Pallas body
// `_kernel`): out[s] = sum of vals[i] over the rows i with ids[i] == s,
// rows whose id lies outside [0, num) dropped.  In the bundle adjuster
// (openmvg_torch/sfm/ba.py::_seg_sum) it reduces J^T r into the pose and
// intrinsic slots once per CG iteration (k = 6 and 8) and the 6x6 / 8x8
// block-Jacobi blocks once per LM step (k = 36 and 64).
//
// The TPU kernel multiplied a one-hot (rows, num) tile into the payload
// on the matrix unit, a workaround for row-serial scatter on the TPU; on
// Hopper that is num times the work, so it is not carried over.  What is
// hard here is determinism: float atomics (global or shared) add in an
// order that changes from launch to launch, and the repo holds the
// adjuster to repeatable results.  So there are no atomics at all:
//
//   plan (ops/seg_sum.py::seg_sum_plan, once per BA problem, because the
//   segment ids are fixed across the LM loop): a stable sort of the valid
//   rows by segment gives `perm`; each segment's run of `perm` is cut into
//   chunks of at most `chunk` rows; `chunk_start/end` hold each chunk's
//   range and `seg_chunk_off` each segment's first chunk.
//
//   pass 1 (seg_sum_chunks): one block of 256 threads per chunk.  Thread t
//   owns column c = t % k and row lane l = t / k of L = 256 / k lanes; it
//   adds rows start + l, start + l + L, ... of its chunk in that order.
//   Threads 0..k-1 then add the L lane sums in lane order and write one
//   row of `partial` (n_chunks, k).
//
//   pass 2 (seg_sum_fold): one thread per output element adds its
//   segment's chunk rows of `partial` in chunk order.
//
// Every output element is therefore one fixed sequence of additions,
// decided by the plan, k and the block size alone: two calls on the same
// input are bitwise equal.  Work is O(rows * k) with no shared-memory
// limit in num; the TPU kernel's cap of 1024 segments is not carried over
// (num * k < 2^31, which the wrapper checks), so the bundle adjuster's
// point-side sums without a group table take this kernel too.  A call is
// two launches, or one (the fold alone) when no row is valid.
//
// Bound: bytes.  The function must read ids (4 B a row) and vals (k * s B
// a row, s = 4 or 8) once and write (num, k) once: at the main path's
// sizes (tens of thousands to a few hundred thousand rows, k = 6 or 36)
// that is a few to a few tens of microseconds at 3.35 TB/s, so the two
// launches' latency is of the same order as the bound.  Measured with
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, on the final bundle
// adjustment of the 100-view run (330,064 rows, num 100): 0.0256 ms for
// J^T r (k 6) against a 0.0028 ms bound, 0.0442 ms for J^T J (k 36)
// against 0.0146 ms.  The plan's permutation is read once more than the
// bound counts (4 B a row), and the gathered rows are k * s contiguous
// bytes each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/seg_sum.py::build), loaded with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_chunks(const T* __restrict__ vals, const int32_t* __restrict__ perm,
               const int32_t* __restrict__ chunk_start,
               const int32_t* __restrict__ chunk_end, int k,
               T* __restrict__ partial) {
  __shared__ T lane_sum[kThreads];
  const int j = blockIdx.x;
  const int lanes = kThreads / k;
  const int c = threadIdx.x % k;
  const int lane = threadIdx.x / k;
  T acc = T(0);
  if (lane < lanes) {
    const int e = chunk_end[j];
    for (int i = chunk_start[j] + lane; i < e; i += lanes)
      acc += vals[static_cast<int64_t>(perm[i]) * k + c];
  }
  lane_sum[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < k) {
    T sum = T(0);
    for (int l = 0; l < lanes; ++l) sum += lane_sum[l * k + threadIdx.x];
    partial[static_cast<int64_t>(j) * k + threadIdx.x] = sum;
  }
}

template <typename T>
__global__ void seg_sum_fold(const T* __restrict__ partial,
                             const int32_t* __restrict__ seg_chunk_off,
                             int num, int k, T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num * k) return;
  const int s = idx / k;
  const int c = idx - s * k;
  T sum = T(0);
  const int e = seg_chunk_off[s + 1];
  for (int j = seg_chunk_off[s]; j < e; ++j)
    sum += partial[static_cast<int64_t>(j) * k + c];
  out[idx] = sum;
}

template <typename T>
int launch(const T* vals, const int32_t* perm, const int32_t* chunk_start,
           const int32_t* chunk_end, const int32_t* seg_chunk_off,
           int n_chunks, int num, int k, T* partial, T* out, void* stream) {
  if (k < 1 || k > kMaxK || num < 0 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0)
    seg_sum_chunks<T><<<n_chunks, kThreads, 0, st>>>(
        vals, perm, chunk_start, chunk_end, k, partial);
  const int total = num * k;
  seg_sum_fold<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, seg_chunk_off, num, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals (rows, k) row-major; perm (n_valid,) row ids sorted by segment;
// chunk_start/chunk_end (n_chunks,) ranges into perm; seg_chunk_off
// (num + 1,) first chunk of each segment; partial (n_chunks, k) scratch;
// out (num, k).  Launches on `stream`; returns cudaGetLastError().
int omt_seg_sum_f32(const float* vals, const int32_t* perm,
                    const int32_t* chunk_start, const int32_t* chunk_end,
                    const int32_t* seg_chunk_off, int n_chunks, int num, int k,
                    float* partial, float* out, void* stream) {
  return launch<float>(vals, perm, chunk_start, chunk_end, seg_chunk_off,
                       n_chunks, num, k, partial, out, stream);
}

int omt_seg_sum_f64(const double* vals, const int32_t* perm,
                    const int32_t* chunk_start, const int32_t* chunk_end,
                    const int32_t* seg_chunk_off, int n_chunks, int num, int k,
                    double* partial, double* out, void* stream) {
  return launch<double>(vals, perm, chunk_start, chunk_end, seg_chunk_off,
                        n_chunks, num, k, partial, out, stream);
}

}  // extern "C"
