// Host library of the port: the float64 polish of a reconstruction, and
// the TBMR detector's component tree.
//
// One Levenberg-Marquardt step of pinhole bundle adjustment with the
// shared intrinsics [f, cx, cy] as three extra global unknowns, copied
// from openmvg_tpu/native/native.cpp (omt_ba_lm_step_k and its helpers):
// per-observation residuals and analytic Jacobians (the exact derivative
// of exp(w) X through the SO(3) right Jacobian), Huber IRLS weights, the
// point blocks eliminated by 3x3 solves (implicit Schur complement),
// block-Jacobi preconditioned CG on the reduced camera system,
// back-substitution, accept or reject.  Double precision, OpenMP over
// observations and blocks.
//
// omt_tbmr is copied from the same file: the max-tree of TBMR, a
// sequential union-find over brightness-sorted pixels (openmvg_torch/ops/
// tbmr.py).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 (openmvg_torch/sfm/
// polish.py builds it into openmvg_torch/_build/ at first use), loaded
// with ctypes.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <vector>

namespace omt_ba {

constexpr int kBlocks = 16;  // fixed observation blocks of the summations

struct V3 { double x, y, z; };

static inline void rodrigues(const double* w, double R[9]) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double th = std::sqrt(th2);
  double a, b;
  if (th < 1e-12) { a = 1.0; b = 0.5; } else { a = std::sin(th) / th; b = (1.0 - std::cos(th)) / th2; }
  const double wx = w[0], wy = w[1], wz = w[2];
  R[0] = 1 - b * (wy * wy + wz * wz); R[1] = -a * wz + b * wx * wy; R[2] = a * wy + b * wx * wz;
  R[3] = a * wz + b * wx * wy; R[4] = 1 - b * (wx * wx + wz * wz); R[5] = -a * wx + b * wy * wz;
  R[6] = -a * wy + b * wx * wz; R[7] = a * wx + b * wy * wz; R[8] = 1 - b * (wx * wx + wy * wy);
}

// right Jacobian of SO(3): Jr(w) = I - c1 [w]x + c2 [w]x^2
static inline void so3_right_jacobian(const double* w, double J[9]) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double th = std::sqrt(th2);
  double c1, c2;
  if (th < 1e-6) { c1 = 0.5 - th2 / 24.0; c2 = 1.0 / 6.0 - th2 / 120.0; }
  else { c1 = (1.0 - std::cos(th)) / th2; c2 = (th - std::sin(th)) / (th2 * th); }
  const double wx = w[0], wy = w[1], wz = w[2];
  const double K[9] = {0, -wz, wy, wz, 0, -wx, -wy, wx, 0};
  double K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += K[i * 3 + k] * K[k * 3 + j];
      K2[i * 3 + j] = s;
    }
  for (int i = 0; i < 9; ++i) J[i] = -c1 * K[i] + c2 * K2[i];
  J[0] += 1; J[4] += 1; J[8] += 1;
}

// 3x3 SPD solve (hand Cholesky)
static inline void solve3(const double A[9], const double b[3], double x[3]) {
  const double l00 = std::sqrt(std::max(A[0], 1e-300));
  const double l10 = A[3] / l00, l20 = A[6] / l00;
  const double l11 = std::sqrt(std::max(A[4] - l10 * l10, 1e-300));
  const double l21 = (A[7] - l20 * l10) / l11;
  const double l22 = std::sqrt(std::max(A[8] - l20 * l20 - l21 * l21, 1e-300));
  const double y0 = b[0] / l00;
  const double y1 = (b[1] - l10 * y0) / l11;
  const double y2 = (b[2] - l20 * y0 - l21 * y1) / l22;
  x[2] = y2 / l22;
  x[1] = (y1 - l21 * x[2]) / l11;
  x[0] = (y0 - l10 * x[1] - l20 * x[2]) / l00;
}

// 6x6 SPD solve via Cholesky (for the block-Jacobi preconditioner)
static inline void solve6(const double* A, const double* b, double* x) {
  double L[36];
  for (int i = 0; i < 36; ++i) L[i] = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * 6 + j];
      for (int k = 0; k < j; ++k) s -= L[i * 6 + k] * L[j * 6 + k];
      if (i == j) L[i * 6 + j] = std::sqrt(std::max(s, 1e-300));
      else L[i * 6 + j] = s / L[j * 6 + j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * y[k];
    y[i] = s / L[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * x[k];
    x[i] = s / L[i * 6 + i];
  }
}

}  // namespace omt_ba

extern "C" {

// One LM step.  Arrays: obs_pose/obs_point (O), obs_x (O,2),
// rotvec/t (P,3) and X (L,3) are UPDATED in place when the step is
// accepted; kp = [f, cx, cy] is also updated when refine_k != 0 (the
// shared pinhole intrinsics ride the Schur-reduced system as 3 extra
// global unknowns — parity with ceres ADJUST_ALL refining intrinsics
// jointly, sfm_data_BA_ceres.cpp, where alternating minimization
// cannot traverse the focal<->depth correlated valley).
// n_threads: OpenMP threads; the result does not depend on it.
// Returns 1 if accepted, 0 if rejected, <0 on error.
// out2: [cost_before, cost_after].
int64_t omt_ba_lm_step_k(const int32_t* obs_pose, const int32_t* obs_point,
                         const double* obs_x, double* rotvec, double* tvec,
                         double* Xpts, double* kp, int32_t refine_k,
                         int64_t O, int64_t P, int64_t L, double lam,
                         int32_t cg_iters, double huber_a, int32_t n_threads,
                         double* out2) {
  using namespace omt_ba;
  const double f = kp[0], cx = kp[1], cy = kp[2];
  std::vector<double> R(P * 9), Jr(P * 9);
  for (int64_t p = 0; p < P; ++p) {
    rodrigues(rotvec + p * 3, &R[p * 9]);
    so3_right_jacobian(rotvec + p * 3, &Jr[p * 9]);
  }
  // per-obs residuals (weighted), Jp (2x6), Jx (2x3), Jk sparse 2x3
  // (stored as {wgt*du/df, wgt*dv/df, wgt}: du/dcx = dv/dcy = 1, rest 0)
  std::vector<double> res(O * 2), Jp(O * 12), Jx(O * 6), Jk(O * 3);
  std::vector<double> Hpp(L * 9, 0.0), gx(L * 3, 0.0);
  std::vector<double> Hcc(P * 36, 0.0), gc(P * 6, 0.0);
  double Hkk[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  double gk[3] = {0, 0, 0};
  double cost0 = 0.0;

  // Fixed blocks of observations, each with partial sums of its own,
  // merged in block order below: the sums do not depend on the thread
  // count or on which thread finishes first.  (The reference merged
  // per-thread partials in a critical section, in arrival order, so two
  // runs could differ in the last bits.)
  std::vector<std::vector<double>> part_hpp(kBlocks), part_gx(kBlocks),
      part_hcc(kBlocks), part_gc(kBlocks);
  std::vector<std::array<double, 13>> part_small(kBlocks);  // Hkk, gk, cost
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(n_threads)
#endif
  for (int b = 0; b < kBlocks; ++b) {
    std::vector<double>& hpp_l = part_hpp[b];
    std::vector<double>& gx_l = part_gx[b];
    std::vector<double>& hcc_l = part_hcc[b];
    std::vector<double>& gc_l = part_gc[b];
    hpp_l.assign(L * 9, 0.0);
    gx_l.assign(L * 3, 0.0);
    hcc_l.assign(P * 36, 0.0);
    gc_l.assign(P * 6, 0.0);
    double hkk_l[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    double gk_l[3] = {0, 0, 0};
    double cost_l = 0.0;
    const int64_t o_end = O * (b + 1) / kBlocks;
    for (int64_t o = O * b / kBlocks; o < o_end; ++o) {
      const int64_t p = obs_pose[o], l = obs_point[o];
      const double* Rp = &R[p * 9];
      const double* Xl = Xpts + l * 3;
      const double Xc[3] = {
          Rp[0] * Xl[0] + Rp[1] * Xl[1] + Rp[2] * Xl[2] + tvec[p * 3 + 0],
          Rp[3] * Xl[0] + Rp[4] * Xl[1] + Rp[5] * Xl[2] + tvec[p * 3 + 1],
          Rp[6] * Xl[0] + Rp[7] * Xl[1] + Rp[8] * Xl[2] + tvec[p * 3 + 2]};
      const double iz = 1.0 / Xc[2];
      const double u = f * Xc[0] * iz + cx, v = f * Xc[1] * iz + cy;
      double r[2] = {u - obs_x[o * 2 + 0], v - obs_x[o * 2 + 1]};
      const double s = r[0] * r[0] + r[1] * r[1];
      // ceres HuberLoss rho: s<=a -> s, else 2 sqrt(a s) - a
      cost_l += 0.5 * (s <= huber_a ? s : 2.0 * std::sqrt(huber_a * s) - huber_a);
      const double wgt = std::sqrt(s <= huber_a ? 1.0 : std::sqrt(huber_a / s));
      // dU/dXc
      const double du[3] = {f * iz, 0.0, -f * Xc[0] * iz * iz};
      const double dv[3] = {0.0, f * iz, -f * Xc[1] * iz * iz};
      // dXc/dw = -R [X]x Jr   (2x3 via row chain)
      const double Kx[9] = {0, -Xl[2], Xl[1], Xl[2], 0, -Xl[0], -Xl[1], Xl[0], 0};
      double RK[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          RK[i * 3 + j] = -(Rp[i * 3 + 0] * Kx[0 * 3 + j] +
                            Rp[i * 3 + 1] * Kx[1 * 3 + j] +
                            Rp[i * 3 + 2] * Kx[2 * 3 + j]);
      double dXc_dw[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          dXc_dw[i * 3 + j] = RK[i * 3 + 0] * Jr[p * 9 + 0 * 3 + j] +
                              RK[i * 3 + 1] * Jr[p * 9 + 1 * 3 + j] +
                              RK[i * 3 + 2] * Jr[p * 9 + 2 * 3 + j];
      double* jp = &Jp[o * 12];
      double* jx = &Jx[o * 6];
      for (int j = 0; j < 3; ++j) {
        jp[0 + j] = wgt * (du[0] * dXc_dw[0 * 3 + j] + du[1] * dXc_dw[1 * 3 + j] + du[2] * dXc_dw[2 * 3 + j]);
        jp[6 + j] = wgt * (dv[0] * dXc_dw[0 * 3 + j] + dv[1] * dXc_dw[1 * 3 + j] + dv[2] * dXc_dw[2 * 3 + j]);
        jp[3 + j] = wgt * du[j];   // dXc/dt = I
        jp[9 + j] = wgt * dv[j];
        jx[0 + j] = wgt * (du[0] * Rp[0 * 3 + j] + du[1] * Rp[1 * 3 + j] + du[2] * Rp[2 * 3 + j]);
        jx[3 + j] = wgt * (dv[0] * Rp[0 * 3 + j] + dv[1] * Rp[1 * 3 + j] + dv[2] * Rp[2 * 3 + j]);
      }
      res[o * 2 + 0] = wgt * r[0];
      res[o * 2 + 1] = wgt * r[1];
      // accumulate blocks
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          hpp_l[l * 9 + i * 3 + j] += jx[i] * jx[j] + jx[3 + i] * jx[3 + j];
      for (int i = 0; i < 3; ++i)
        gx_l[l * 3 + i] -= jx[i] * res[o * 2] + jx[3 + i] * res[o * 2 + 1];
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j)
          hcc_l[p * 36 + i * 6 + j] += jp[i] * jp[j] + jp[6 + i] * jp[6 + j];
        gc_l[p * 6 + i] -= jp[i] * res[o * 2] + jp[6 + i] * res[o * 2 + 1];
      }
      if (refine_k) {
        double* jk = &Jk[o * 3];
        jk[0] = wgt * Xc[0] * iz;  // du/df
        jk[1] = wgt * Xc[1] * iz;  // dv/df
        jk[2] = wgt;               // du/dcx = dv/dcy
        // Hkk (symmetric; [1][2] = 0 exactly)
        hkk_l[0] += jk[0] * jk[0] + jk[1] * jk[1];
        hkk_l[1] += jk[0] * jk[2];
        hkk_l[2] += jk[1] * jk[2];
        hkk_l[4] += jk[2] * jk[2];
        hkk_l[8] += jk[2] * jk[2];
        gk_l[0] -= jk[0] * res[o * 2] + jk[1] * res[o * 2 + 1];
        gk_l[1] -= jk[2] * res[o * 2];
        gk_l[2] -= jk[2] * res[o * 2 + 1];
      }
    }
    for (int i = 0; i < 9; ++i) part_small[b][i] = hkk_l[i];
    for (int i = 0; i < 3; ++i) part_small[b][9 + i] = gk_l[i];
    part_small[b][12] = cost_l;
  }
  for (int b = 0; b < kBlocks; ++b) {
    for (int64_t i = 0; i < (int64_t)Hpp.size(); ++i) Hpp[i] += part_hpp[b][i];
    for (int64_t i = 0; i < (int64_t)gx.size(); ++i) gx[i] += part_gx[b][i];
    for (int64_t i = 0; i < (int64_t)Hcc.size(); ++i) Hcc[i] += part_hcc[b][i];
    for (int64_t i = 0; i < (int64_t)gc.size(); ++i) gc[i] += part_gc[b][i];
    for (int i = 0; i < 9; ++i) Hkk[i] += part_small[b][i];
    for (int i = 0; i < 3; ++i) gk[i] += part_small[b][9 + i];
    cost0 += part_small[b][12];
  }
  Hkk[3] = Hkk[1];
  Hkk[6] = Hkk[2];
  Hkk[7] = Hkk[5];  // zero

  // damp
  std::vector<double> HppD(Hpp);
  for (int64_t l = 0; l < L; ++l)
    for (int i = 0; i < 3; ++i)
      HppD[l * 9 + i * 3 + i] += lam * std::max(Hpp[l * 9 + i * 3 + i], 1e-12) + 1e-12;
  std::vector<double> Mp(P * 36);
  for (int64_t p = 0; p < P; ++p) {
    for (int i = 0; i < 36; ++i) Mp[p * 36 + i] = Hcc[p * 36 + i];
    for (int i = 0; i < 6; ++i)
      Mp[p * 36 + i * 6 + i] += lam * std::max(Hcc[p * 36 + i * 6 + i], 1e-12) + 1e-12;
  }
  double Mk[9];
  for (int i = 0; i < 9; ++i) Mk[i] = Hkk[i];
  for (int i = 0; i < 3; ++i)
    Mk[i * 3 + i] += lam * std::max(Hkk[i * 3 + i], 1e-12) + 1e-12;

  // N unknowns: 6 per pose + (optionally) the 3 shared intrinsics
  const int64_t N = P * 6 + (refine_k ? 3 : 0);
  const int64_t KO = P * 6;  // offset of the intrinsic block

  // reduced rhs b = g - E Hpp^-1 gx
  std::vector<double> HinvGx(L * 3);
  for (int64_t l = 0; l < L; ++l) solve3(&HppD[l * 9], &gx[l * 3], &HinvGx[l * 3]);
  std::vector<double> bred(N);
  for (int64_t i = 0; i < P * 6; ++i) bred[i] = gc[i];
  if (refine_k) for (int i = 0; i < 3; ++i) bred[KO + i] = gk[i];
  for (int64_t o = 0; o < O; ++o) {
    const int64_t p = obs_pose[o], l = obs_point[o];
    const double* jx = &Jx[o * 6];
    const double* jp = &Jp[o * 12];
    const double zu = jx[0] * HinvGx[l * 3] + jx[1] * HinvGx[l * 3 + 1] + jx[2] * HinvGx[l * 3 + 2];
    const double zv = jx[3] * HinvGx[l * 3] + jx[4] * HinvGx[l * 3 + 1] + jx[5] * HinvGx[l * 3 + 2];
    for (int i = 0; i < 6; ++i) bred[p * 6 + i] -= jp[i] * zu + jp[6 + i] * zv;
    if (refine_k) {
      const double* jk = &Jk[o * 3];
      bred[KO + 0] -= jk[0] * zu + jk[1] * zv;
      bred[KO + 1] -= jk[2] * zu;
      bred[KO + 2] -= jk[2] * zv;
    }
  }

  // CG on S dc = bred with block-Jacobi preconditioner
  std::vector<double> dc(N, 0.0), rr(bred), z(N), pp(N), Ap(N);
  std::vector<double> u(O * 2), w3(L * 3), y3(L * 3);
  auto S_matvec = [&](const std::vector<double>& vin, std::vector<double>& vout) {
    // u = J v ; w = Jx^T u ; y = Hpp^-1 w ; out = J^T(u - Jx y) + lam D v
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads)
#endif
    for (int64_t o = 0; o < O; ++o) {
      const int64_t p = obs_pose[o];
      const double* jp = &Jp[o * 12];
      double su = 0, sv = 0;
      for (int i = 0; i < 6; ++i) {
        su += jp[i] * vin[p * 6 + i];
        sv += jp[6 + i] * vin[p * 6 + i];
      }
      if (refine_k) {
        const double* jk = &Jk[o * 3];
        su += jk[0] * vin[KO] + jk[2] * vin[KO + 1];
        sv += jk[1] * vin[KO] + jk[2] * vin[KO + 2];
      }
      u[o * 2] = su;
      u[o * 2 + 1] = sv;
    }
    std::fill(w3.begin(), w3.end(), 0.0);
    for (int64_t o = 0; o < O; ++o) {
      const int64_t l = obs_point[o];
      const double* jx = &Jx[o * 6];
      for (int i = 0; i < 3; ++i)
        w3[l * 3 + i] += jx[i] * u[o * 2] + jx[3 + i] * u[o * 2 + 1];
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads)
#endif
    for (int64_t l = 0; l < L; ++l) solve3(&HppD[l * 9], &w3[l * 3], &y3[l * 3]);
    std::fill(vout.begin(), vout.end(), 0.0);
    for (int64_t o = 0; o < O; ++o) {
      const int64_t p = obs_pose[o], l = obs_point[o];
      const double* jx = &Jx[o * 6];
      const double* jp = &Jp[o * 12];
      const double zu = u[o * 2] - (jx[0] * y3[l * 3] + jx[1] * y3[l * 3 + 1] + jx[2] * y3[l * 3 + 2]);
      const double zv = u[o * 2 + 1] - (jx[3] * y3[l * 3] + jx[4] * y3[l * 3 + 1] + jx[5] * y3[l * 3 + 2]);
      for (int i = 0; i < 6; ++i) vout[p * 6 + i] += jp[i] * zu + jp[6 + i] * zv;
      if (refine_k) {
        const double* jk = &Jk[o * 3];
        vout[KO + 0] += jk[0] * zu + jk[1] * zv;
        vout[KO + 1] += jk[2] * zu;
        vout[KO + 2] += jk[2] * zv;
      }
    }
    for (int64_t p = 0; p < P; ++p)
      for (int i = 0; i < 6; ++i)
        vout[p * 6 + i] += lam * std::max(Hcc[p * 36 + i * 6 + i], 1e-12) * vin[p * 6 + i];
    if (refine_k)
      for (int i = 0; i < 3; ++i)
        vout[KO + i] += lam * std::max(Hkk[i * 3 + i], 1e-12) * vin[KO + i];
  };
  auto precond = [&](const std::vector<double>& rin, std::vector<double>& zout) {
    for (int64_t p = 0; p < P; ++p) solve6(&Mp[p * 36], &rin[p * 6], &zout[p * 6]);
    if (refine_k) solve3(Mk, &rin[KO], &zout[KO]);
  };
  precond(rr, z);
  pp = z;
  double rz = 0;
  for (int64_t i = 0; i < N; ++i) rz += rr[i] * z[i];
  for (int32_t it = 0; it < cg_iters; ++it) {
    S_matvec(pp, Ap);
    double pAp = 0;
    for (int64_t i = 0; i < N; ++i) pAp += pp[i] * Ap[i];
    const double alpha = rz / (std::fabs(pAp) < 1e-30 ? 1e-30 : pAp);
    for (int64_t i = 0; i < N; ++i) { dc[i] += alpha * pp[i]; rr[i] -= alpha * Ap[i]; }
    precond(rr, z);
    double rz2 = 0;
    for (int64_t i = 0; i < N; ++i) rz2 += rr[i] * z[i];
    const double beta = rz2 / (std::fabs(rz) < 1e-30 ? 1e-30 : rz);
    for (int64_t i = 0; i < N; ++i) pp[i] = z[i] + beta * pp[i];
    rz = rz2;
  }

  // back-substitute points: d_X = Hpp^-1 (gx - E^T dc)
  std::fill(w3.begin(), w3.end(), 0.0);
  for (int64_t o = 0; o < O; ++o) {
    const int64_t p = obs_pose[o], l = obs_point[o];
    const double* jp = &Jp[o * 12];
    const double* jx = &Jx[o * 6];
    double su = 0, sv = 0;
    for (int i = 0; i < 6; ++i) {
      su += jp[i] * dc[p * 6 + i];
      sv += jp[6 + i] * dc[p * 6 + i];
    }
    if (refine_k) {
      const double* jk = &Jk[o * 3];
      su += jk[0] * dc[KO] + jk[2] * dc[KO + 1];
      sv += jk[1] * dc[KO] + jk[2] * dc[KO + 2];
    }
    for (int i = 0; i < 3; ++i)
      w3[l * 3 + i] += jx[i] * su + jx[3 + i] * sv;
  }
  std::vector<double> dX(L * 3);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads)
#endif
  for (int64_t l = 0; l < L; ++l) {
    double rhs[3] = {gx[l * 3] - w3[l * 3], gx[l * 3 + 1] - w3[l * 3 + 1],
                     gx[l * 3 + 2] - w3[l * 3 + 2]};
    solve3(&HppD[l * 9], rhs, &dX[l * 3]);
  }

  // tentative step + new cost
  const double f2 = refine_k ? f + dc[KO] : f;
  const double cx2 = refine_k ? cx + dc[KO + 1] : cx;
  const double cy2 = refine_k ? cy + dc[KO + 2] : cy;
  std::vector<double> rv2(P * 3), tv2(P * 3), X2(L * 3);
  for (int64_t i = 0; i < P * 3; ++i) rv2[i] = rotvec[i] + dc[(i / 3) * 6 + (i % 3)];
  for (int64_t i = 0; i < P * 3; ++i) tv2[i] = tvec[i] + dc[(i / 3) * 6 + 3 + (i % 3)];
  for (int64_t i = 0; i < L * 3; ++i) X2[i] = Xpts[i] + dX[i];
  double cost1_part[kBlocks];
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(n_threads)
#endif
  for (int b = 0; b < kBlocks; ++b) {
    double cost1 = 0.0;
    const int64_t o_end = O * (b + 1) / kBlocks;
    for (int64_t o = O * b / kBlocks; o < o_end; ++o) {
      const int64_t p = obs_pose[o], l = obs_point[o];
      double Rp[9];
      rodrigues(&rv2[p * 3], Rp);
      const double* Xl = &X2[l * 3];
      const double Xc[3] = {
          Rp[0] * Xl[0] + Rp[1] * Xl[1] + Rp[2] * Xl[2] + tv2[p * 3 + 0],
          Rp[3] * Xl[0] + Rp[4] * Xl[1] + Rp[5] * Xl[2] + tv2[p * 3 + 1],
          Rp[6] * Xl[0] + Rp[7] * Xl[1] + Rp[8] * Xl[2] + tv2[p * 3 + 2]};
      const double iz = 1.0 / Xc[2];
      const double du_ = f2 * Xc[0] * iz + cx2 - obs_x[o * 2 + 0];
      const double dv_ = f2 * Xc[1] * iz + cy2 - obs_x[o * 2 + 1];
      const double s = du_ * du_ + dv_ * dv_;
      cost1 += 0.5 * (s <= huber_a ? s : 2.0 * std::sqrt(huber_a * s) - huber_a);
    }
    cost1_part[b] = cost1;
  }
  double cost1 = 0.0;
  for (int b = 0; b < kBlocks; ++b) cost1 += cost1_part[b];
  out2[0] = cost0;
  out2[1] = cost1;
  if (cost1 < cost0) {
    std::copy(rv2.begin(), rv2.end(), rotvec);
    std::copy(tv2.begin(), tv2.end(), tvec);
    std::copy(X2.begin(), X2.end(), Xpts);
    if (refine_k) { kp[0] = f2; kp[1] = cx2; kp[2] = cy2; }
    return 1;
  }
  return 0;
}

// TBMR (tree-based Morse regions): exact max-tree via union-find over
// brightness-sorted pixels with incremental region moments, canonization,
// then selection of the largest topology-preserving region per critical
// branch (features/tbmr/tbmr.cpp semantics, own implementation of
// Xu/Monasse/Geraud/Najman, PAMI 2014).
//
// img: h*w uint8. invert!=0 detects dark regions (min-tree). Writes up to
// max_out rows of (x, y, a, b, c, area) into `out`; returns the count.
int64_t omt_tbmr(const uint8_t* img, int64_t w, int64_t h, int32_t invert,
                 int64_t min_size, double max_rel_size, double* out,
                 int64_t max_out) {
  const int64_t n = w * h;
  if (n == 0) return 0;

  // counting sort: S = pixel ids ordered so that the *tree root end*
  // (darkest for max-tree) comes first; we then scan S backwards.
  std::vector<int64_t> hist(257, 0);
  std::vector<uint8_t> key(n);
  for (int64_t i = 0; i < n; ++i) {
    key[i] = invert ? (uint8_t)(255 - img[i]) : img[i];
    ++hist[key[i] + 1];
  }
  for (int k = 0; k < 256; ++k) hist[k + 1] += hist[k];
  std::vector<int64_t> S(n);
  {
    std::vector<int64_t> cur(hist.begin(), hist.begin() + 256);
    for (int64_t i = 0; i < n; ++i) S[cur[key[i]]++] = i;
  }

  std::vector<int64_t> parent(n), zpar(n), comp_root(n);
  std::vector<int32_t> rank_(n, 0);
  std::vector<uint8_t> seen(n, 0);
  // region attributes, accumulated at the current component root pixel
  std::vector<int64_t> area(n, 0);
  std::vector<double> sx(n, 0), sy(n, 0), sxx(n, 0), syy(n, 0), sxy(n, 0);

  // path-halving find on zpar
  auto zfind = [&](int64_t p) {
    while (zpar[p] != p) {
      zpar[p] = zpar[zpar[p]];
      p = zpar[p];
    }
    return p;
  };

  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t p = S[i];
    parent[p] = p;
    zpar[p] = p;
    comp_root[p] = p;
    seen[p] = 1;
    const double px = (double)(p % w), py = (double)(p / w);
    area[p] = 1;
    sx[p] = px; sy[p] = py;
    sxx[p] = px * px; syy[p] = py * py; sxy[p] = px * py;

    int64_t x = p;
    const int64_t col = p % w;
    const int64_t nb[4] = {p - w, p + w, col > 0 ? p - 1 : -1,
                           col + 1 < w ? p + 1 : -1};
    for (int k = 0; k < 4; ++k) {
      const int64_t q = nb[k];
      if (q < 0 || q >= n || !seen[q]) continue;
      const int64_t r = zfind(q);
      if (r == x) continue;
      parent[comp_root[r]] = p;
      area[p] += area[comp_root[r]];
      sx[p] += sx[comp_root[r]];
      sy[p] += sy[comp_root[r]];
      sxx[p] += sxx[comp_root[r]];
      syy[p] += syy[comp_root[r]];
      sxy[p] += sxy[comp_root[r]];
      if (rank_[x] < rank_[r]) {
        zpar[x] = r;
        comp_root[r] = p;
        x = r;
      } else if (rank_[r] < rank_[x]) {
        zpar[r] = x;
      } else {
        zpar[r] = x;
        ++rank_[x];
      }
    }
  }

  // canonization: level-equal parents collapse to their canonical element
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = S[i];
    const int64_t q = parent[p];
    if (img[parent[q]] == img[q]) parent[p] = parent[q];
  }

  // canonical nodes + per-parent counts of large-enough sons
  std::vector<int32_t> num_sons(n, 0);
  std::vector<int64_t> nodes;
  nodes.reserve(n / 4);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t p = S[i];
    if (parent[p] == p || img[p] != img[parent[p]]) {
      nodes.push_back(p);
      if (area[p] >= min_size) ++num_sons[parent[p]];
    }
  }

  std::vector<uint8_t> is_parent_of_leaf(n, 0);
  for (const int64_t p : nodes)
    if (num_sons[p] == 0 && num_sons[parent[p]] == 1)
      is_parent_of_leaf[parent[p]] = 1;

  const int64_t max_area = (int64_t)(max_rel_size * (double)n);
  std::vector<uint8_t> visited(n, 0);
  int64_t count = 0;
  for (const int64_t p : nodes) {
    if (num_sons[p] != 1 || visited[p] || area[p] > max_area) continue;
    int64_t pt = p, po = p;
    int64_t ancestors = 0;
    while (num_sons[pt] == 1 && area[pt] <= max_area) {
      visited[pt] = 1;
      ++ancestors;
      po = pt;
      pt = parent[pt];
    }
    if (is_parent_of_leaf[p] && ancestors <= 1) continue;

    const double A = (double)area[po];
    const double cx = sx[po] / A, cy = sy[po] / A;
    const double i20 = sxx[po] - A * cx * cx;
    const double i02 = syy[po] - A * cy * cy;
    const double i11 = sxy[po] - A * cx * cy;
    const double det = i20 * i02 - i11 * i11;
    if (det == 0.0) continue;
    const double a = i02 / det * (A - 1.0) / 4.0;
    const double b = -i11 / det * (A - 1.0) / 4.0;
    const double c = i20 / det * (A - 1.0) / 4.0;
    // minor semi-axis (feature.cpp:104-107): reject thin/tiny ellipses
    const double disc = a * a + c * c + 4.0 * b * b - 2.0 * a * c;
    const double e_big = (a + c + std::sqrt(disc > 0 ? disc : 0)) / 2.0;
    if (e_big <= 0) continue;
    const double l_min = 1.0 / std::sqrt(e_big);
    if (l_min < 1.5) continue;
    if (count < max_out) {
      out[count * 6 + 0] = cx;
      out[count * 6 + 1] = cy;
      out[count * 6 + 2] = a;
      out[count * 6 + 3] = b;
      out[count * 6 + 4] = c;
      out[count * 6 + 5] = A;
      ++count;
    }
  }
  return count;
}

}  // extern "C"
