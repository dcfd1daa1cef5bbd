// The reference's CPU baselines, for comparing the port's card kernels
// with a CPU (openmvg_torch/native.py; copied from openmvg_tpu/native/
// native.cpp):
//   - omt_bench_match_2nn: brute-force uint8 L2 2-NN with the ratio test,
//     AVX2 with OpenMP over the left rows (the design of openMVG's
//     matching/metric_simd.hpp and Matcher_Regions.cpp); without __AVX2__
//     the scalar loop gives the same integer distances, so the same
//     indices and keep flags;
//   - omt_bench_ba_lm_step: one LM step of pinhole bundle adjustment with
//     the intrinsics fixed, a wrapper of native.cpp's omt_ba_lm_step_k.
//
// Build: g++ -O3 -fopenmp -march=native -shared -fPIC -std=c++17, as the
// reference's native/Makefile builds its baselines (openmvg_torch/utils/
// build.py::bench_library, at first use, into openmvg_torch/_build/).  A
// library of its own: native.cpp keeps its own flags, under which FMA
// contraction cannot move the f64 polish's bits.

#include "native.cpp"

#include <climits>
#ifdef _OPENMP
#include <omp.h>
#endif
#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// For every row of a (n x dim), its nearest row of b (m x dim) by squared
// L2 distance (the first of equal ones) in out_idx, and in out_keep
// whether best < ratio^2 * second.  dim must be a multiple of 32.
// Returns the number kept, or -1.
int64_t omt_bench_match_2nn(const uint8_t* a, int64_t n, const uint8_t* b, int64_t m,
                            int64_t dim, double ratio, int32_t* out_idx, int32_t* out_keep) {
  if (dim % 32 != 0) return -1;
  const double r2 = ratio * ratio;
  int64_t kept = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : kept)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* ai = a + i * dim;
    int32_t best = INT32_MAX, second = INT32_MAX, arg = -1;
    for (int64_t j = 0; j < m; ++j) {
      const uint8_t* bj = b + j * dim;
      int32_t d = 0;
#if defined(__AVX2__)
      __m256i acc = _mm256_setzero_si256();
      for (int64_t k = 0; k < dim; k += 32) {
        const __m256i va = _mm256_loadu_si256((const __m256i*)(ai + k));
        const __m256i vb = _mm256_loadu_si256((const __m256i*)(bj + k));
        // |va - vb| per u8 lane, then widen and square-accumulate
        const __m256i df = _mm256_sub_epi8(_mm256_max_epu8(va, vb), _mm256_min_epu8(va, vb));
        const __m256i lo = _mm256_unpacklo_epi8(df, _mm256_setzero_si256());
        const __m256i hi = _mm256_unpackhi_epi8(df, _mm256_setzero_si256());
        acc = _mm256_add_epi32(acc, _mm256_madd_epi16(lo, lo));
        acc = _mm256_add_epi32(acc, _mm256_madd_epi16(hi, hi));
      }
      alignas(32) int32_t lanes[8];
      _mm256_store_si256((__m256i*)lanes, acc);
      d = lanes[0] + lanes[1] + lanes[2] + lanes[3] + lanes[4] + lanes[5] + lanes[6] + lanes[7];
#else
      for (int64_t k = 0; k < dim; ++k) {
        const int32_t df = (int32_t)ai[k] - (int32_t)bj[k];
        d += df * df;
      }
#endif
      if (d < best) {
        second = best;
        best = d;
        arg = (int32_t)j;
      } else if (d < second) {
        second = d;
      }
    }
    out_idx[i] = arg;
    const int k = (double)best < r2 * (double)second;
    out_keep[i] = k;
    kept += k;
  }
  return kept;
}

// omt_ba_lm_step_k with [f, cx, cy] fixed (the reference's ABI): rotvec,
// tvec and Xpts are updated in place when the step is accepted; returns 1
// accepted, 0 rejected, <0 on error; out2 = [cost before, cost after].
int64_t omt_bench_ba_lm_step(const int32_t* obs_pose, const int32_t* obs_point,
                             const double* obs_x, double* rotvec, double* tvec, double* Xpts,
                             double f, double cx, double cy, int64_t O, int64_t P, int64_t L,
                             double lam, int32_t cg_iters, double huber_a, double* out2) {
  double kp[3] = {f, cx, cy};
#ifdef _OPENMP
  const int32_t threads = omp_get_max_threads();
#else
  const int32_t threads = 1;
#endif
  return omt_ba_lm_step_k(obs_pose, obs_point, obs_x, rotvec, tvec, Xpts, kp, 0, O, P, L, lam,
                          cg_iters, huber_a, threads, out2);
}

}  // extern "C"
