"""Robust estimation, the AC-RANSAC kernel layer (counterpart:
openmvg_tpu/sfm/robust.py): the geometric filter's models (F, H, E and the
angular, upright and orthographic essential kernels), relative pose and
resection for the engines, and the batched pose-only refine.

Reference parity: the GeometricFilter F functor (F_ACRobust.hpp: 7-point
on image-size-conditioned coordinates, pixel point-to-line NFA), the H
functor (4-point DLT, pixel transfer error, point-to-point NFA), the
angular and upright E functors (E_ACRobust_Angular.hpp: squared-radian
residual) and the orthographic one (Eo_Robust.hpp: algebraic residual on
the camera plane);
robustRelativePose (5-point E, pixel point-to-line through K, inlier
floor 2.5 x min_samples, cheirality pose recovery; 8-point angular for
non-pinhole pairs); ACKernelAdaptorResection_K (P3P, pixel reprojection
NFA).  Thresholds in and out are squared pixels (squared radians for the
angular kernels).  Every function carries a leading batch dimension (one
pair or view per row) with one torch.Generator per row, or a Gumbel table
that a test shares with the reference.
"""

import math
from typing import NamedTuple

import torch

from openmvg_torch.geometry import so3
from openmvg_torch.models import cameras
from openmvg_torch.ops import (conditioning, essential, fundamental, homography, linalg,
                               ransac, resection)


def robust_fundamental_batch(generators, x1, x2, valid, w1, h1, w2, h2,
                             n_samples=1024, precision_sq=float("inf"),
                             gumbel=None):
    """AC-RANSAC F for B image pairs at once.

    x1, x2 (B, N, 2) pixels; valid (B, N); w*, h* (B,) image sizes;
    generators: B torch.Generators (one random stream per pair), unused when
    a (B, n_samples, N) `gumbel` table is given.  Returns ACRansacResult
    with model = F (B, 3, 3)."""
    dt, dev = x1.dtype, x1.device
    T1 = conditioning.preconditioner_from_size(w1, h1, dt, dev)[:, None, None]
    T2 = conditioning.preconditioner_from_size(w2, h2, dt, dev)[:, None, None]

    def fit(sub):
        a, b = sub  # (B, S, s, 2)
        an = conditioning.apply_transform(T1[:, :, 0], a)
        bn = conditioning.apply_transform(T2[:, :, 0], b)
        Fs, ok = fundamental.solve_7pt(an, bn)   # (B, S, 3, 3, 3)
        return T2.transpose(-1, -2) @ Fs @ T1, ok

    def err(F, data):
        a, b = data
        return fundamental.point_line_error_sq(F, a[:, None], b[:, None])

    return ransac.ac_ransac(
        generators, fit, err, (x1, x2), valid, min_samples=7,
        logalpha0=ransac.logalpha0_point_to_line(w2, h2, dtype=dt).to(dev),
        mult_error=ransac.MULT_ERROR_POINT_TO_LINE,
        max_models=3, n_samples=n_samples,
        precision_sq=precision_sq, gumbel=gumbel)


def robust_fundamental(generator, x1, x2, valid, w1, h1, w2, h2,
                       n_samples=1024, precision_sq=float("inf"),
                       gumbel=None):
    """One pair: x1, x2 (N, 2), valid (N,); gumbel (n_samples, N) or None.
    Returns ACRansacResult without the batch dimension."""
    def one(v):
        return torch.as_tensor(v, dtype=x1.dtype).reshape(1)

    res = robust_fundamental_batch(
        [generator], x1[None], x2[None], valid[None], one(w1), one(h1),
        one(w2), one(h2), n_samples=n_samples, precision_sq=precision_sq,
        gumbel=None if gumbel is None else gumbel[None])
    return ransac.ACRansacResult(*[x[0] for x in res])


def robust_homography_batch(generators, x1, x2, valid, w1, h1, w2, h2,
                            n_samples=1024, precision_sq=float("inf"), gumbel=None):
    """AC-RANSAC H for B image pairs at once (the geometric filter's model
    "h", H_ACRobust): 4-point DLT on image-size-conditioned coordinates,
    the pixel transfer error and point-to-point NFA.  Arguments as
    robust_fundamental_batch; model = H (B, 3, 3), x2 ~ H x1."""
    dt, dev = x1.dtype, x1.device
    T1 = conditioning.preconditioner_from_size(w1, h1, dt, dev)[:, None]
    T2 = conditioning.preconditioner_from_size(w2, h2, dt, dev)
    T2inv = linalg.inv(T2)[:, None]

    def fit(sub):
        a, b = sub  # (B, S, 4, 2)
        H = homography.solve_homography(conditioning.apply_transform(T1, a),
                                        conditioning.apply_transform(T2[:, None], b))
        H = T2inv @ H @ T1
        return H[:, :, None], torch.ones(H.shape[:2] + (1,), dtype=torch.bool, device=dev)

    def err(H, data):
        return homography.asymmetric_error_sq(H, data[0][:, None], data[1][:, None])

    return ransac.ac_ransac(
        generators, fit, err, (x1, x2), valid, min_samples=4,
        logalpha0=ransac.logalpha0_point_to_point(w2, h2, dtype=dt).to(dev),
        mult_error=ransac.MULT_ERROR_POINT_TO_POINT, max_models=1,
        n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_homography(generator, x1, x2, valid, w1, h1, w2, h2,
                      n_samples=1024, precision_sq=float("inf"), gumbel=None):
    """One pair (no batch dimension); gumbel (n_samples, N) or None."""
    return _single(robust_homography_batch, generator, x1, x2, valid,
                   *(_one(v, x1)[0] for v in (w1, h1, w2, h2)), n_samples=n_samples,
                   precision_sq=precision_sq, gumbel=gumbel)


# ---------------------------------------------------------------------------
# relative pose (robustRelativePose, sfm_robust_model_estimation.cpp:29-120)
# ---------------------------------------------------------------------------

class RelativePoseInfo(NamedTuple):
    R: torch.Tensor          # (B, 3, 3) relative rotation
    t: torch.Tensor          # (B, 3) unit-norm relative translation
    essential: torch.Tensor  # (B, 3, 3)
    inliers: torch.Tensor    # (B, N) bool
    threshold_sq: torch.Tensor
    nfa: torch.Tensor
    found: torch.Tensor      # NFA < 0 and more than 2.5 x min_samples inliers


def _fit_8pt(sub):
    E = essential.solve_essential_8pt(*sub)
    return E[:, :, None], torch.ones(E.shape[:2] + (1,), dtype=torch.bool, device=E.device)


def _angular_err(E, data):
    return essential.angular_error(E, data[0][:, None], data[1][:, None])


def _essential_kernel(b1, b2, x1, x2, K1, K2, w2, h2, angular):
    """(fit, err, min_samples, logalpha0, mult_error, max_models) of the
    5-point pixel point-to-line kernel (ACKernelAdaptorEssential), or of
    the 8-point angular kernel (ACKernelAdaptor_AngularRadianError)."""
    if angular:
        return _fit_8pt, _angular_err, 8, ransac.LOGALPHA0_ANGULAR, ransac.MULT_ERROR_ANGULAR, 1
    K1inv = linalg.inv(K1)[:, None]
    K2invT = linalg.inv(K2).transpose(-1, -2)[:, None]

    def fit(sub):
        return essential.solve_essential_5pt(*sub)

    def err(E, data):
        return fundamental.point_line_error_sq(K2invT @ E @ K1inv, x1[:, None], x2[:, None])

    la0 = ransac.logalpha0_point_to_line(w2, h2, 0.5, dtype=b1.dtype).to(b1.device)
    return fit, err, 5, la0, ransac.MULT_ERROR_POINT_TO_LINE, 10


def robust_essential_batch(generators, b1, b2, x1, x2, K1, K2, valid, w2, h2,
                           n_samples=1024, precision_sq=math.inf, gumbel=None):
    """5-point AC-RANSAC on E for B pairs at once (the geometric filter's
    model "e", E_ACRobust.hpp): b* (B, N, 3) unit bearings, x* (B, N, 2)
    pixels, K* (B, 3, 3), valid (B, N), w2/h2 (B,); the residual is the
    pixel point-to-line distance through F = K2^-T E K1^-1.  Returns
    ACRansacResult with model = E (B, 3, 3)."""
    fit, err, s, la0, mult, mm = _essential_kernel(b1, b2, x1, x2, K1, K2, w2, h2, False)
    return ransac.ac_ransac(generators, fit, err, (b1, b2), valid, min_samples=s,
                            logalpha0=la0, mult_error=mult, max_models=mm,
                            n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_essential(generator, b1, b2, x1, x2, K1, K2, valid, w2, h2,
                     n_samples=1024, precision_sq=math.inf, gumbel=None):
    """One pair (no batch dimension); gumbel (n_samples, N) or None."""
    res = robust_essential_batch(
        [generator], b1[None], b2[None], x1[None], x2[None], K1[None], K2[None],
        valid[None], _one(w2, b1), _one(h2, b1), n_samples=n_samples,
        precision_sq=precision_sq, gumbel=None if gumbel is None else gumbel[None])
    return ransac.ACRansacResult(*[x[0] for x in res])


def _bearing_models(generators, fit, b1, b2, valid, min_samples, n_samples,
                    precision_sq, gumbel):
    """AC-RANSAC of a one-model bearing solver with the angular residual
    (ACKernelAdaptor_AngularRadianError)."""
    return ransac.ac_ransac(generators, fit, _angular_err, (b1, b2), valid,
                            min_samples=min_samples,
                            logalpha0=ransac.LOGALPHA0_ANGULAR,
                            mult_error=ransac.MULT_ERROR_ANGULAR, max_models=1,
                            n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_essential_angular_batch(generators, b1, b2, valid, n_samples=1024,
                                   precision_sq=math.inf, gumbel=None):
    """8-point AC-RANSAC on bearings (B, N, 3) with the angular residual:
    the geometric filter's model "a" (E_ACRobust_Angular.hpp).  Returns
    ACRansacResult with model = E (B, 3, 3)."""
    return _bearing_models(generators, _fit_8pt, b1, b2, valid, 8, n_samples, precision_sq,
                           gumbel)


def robust_essential_upright_batch(generators, b1, b2, valid, n_samples=1024,
                                   precision_sq=math.inf, gumbel=None):
    """3-point upright AC-RANSAC on bearings with the angular residual: the
    geometric filter's model "u" (GeometricFilter_ESphericalMatrix_AC_Angular
    with ThreePointUprightRelativePoseSolver, main_GeometricFilter.cpp:350-356)."""
    def fit(sub):
        E, ok = essential.solve_essential_upright_3pt(*sub)
        return E[:, :, None], ok[:, :, None]

    return _bearing_models(generators, fit, b1, b2, valid, 3, n_samples, precision_sq,
                           gumbel)


def robust_essential_ortho_batch(generators, x1, x2, valid, w2, h2, precision_sq,
                                 n_samples=1024, gumbel=None):
    """3-point orthographic-E AC-RANSAC on camera-plane points (B, N, 2):
    the geometric filter's model "o" (GeometricFilter_EOMatrix_RA,
    Eo_Robust.hpp:105-120).  precision_sq (B,) is per pair, already in
    camera-plane units (Eo_Robust.hpp:96-100); the NFA's logalpha0 stays on
    the image size, as the reference kernel's does.  Two models a sample."""
    def fit(sub):
        return essential.solve_essential_ortho_3pt(*sub)

    def err(E, data):
        return essential.ortho_essential_error_sq(E, data[0][:, None], data[1][:, None])

    la0 = ransac.logalpha0_point_to_line(w2, h2, 0.5, dtype=x1.dtype).to(x1.device)
    return ransac.ac_ransac(generators, fit, err, (x1, x2), valid, min_samples=3,
                            logalpha0=la0, mult_error=ransac.MULT_ERROR_POINT_TO_LINE,
                            max_models=2, n_samples=n_samples, precision_sq=precision_sq,
                            gumbel=gumbel)


def _single(batch_fn, generator, *args, gumbel=None, **kw):
    """One problem through a batch form: every tensor argument gains and
    the result loses a leading dimension of 1."""
    def lift(a):
        return a[None] if torch.is_tensor(a) else a

    res = batch_fn([generator], *map(lift, args), gumbel=None if gumbel is None else gumbel[None],
                   **kw)
    return ransac.ACRansacResult(*[ransac.tree_map(lambda a: a[0], x) for x in res])


def robust_essential_angular(generator, b1, b2, valid, n_samples=1024,
                             precision_sq=math.inf, gumbel=None):
    """One pair (no batch dimension)."""
    return _single(robust_essential_angular_batch, generator, b1, b2, valid,
                   n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_essential_upright(generator, b1, b2, valid, n_samples=1024,
                             precision_sq=math.inf, gumbel=None):
    """One pair (no batch dimension)."""
    return _single(robust_essential_upright_batch, generator, b1, b2, valid,
                   n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_essential_ortho(generator, x1, x2, valid, w2, h2, n_samples=1024,
                           precision_sq=math.inf, gumbel=None):
    """One pair (no batch dimension); w2, h2 and precision_sq scalars."""
    return _single(robust_essential_ortho_batch, generator, x1, x2, valid, _one(w2, x1)[0],
                   _one(h2, x1)[0], _one(precision_sq, x1)[0], n_samples=n_samples,
                   gumbel=gumbel)


def _relative_pose_info(res, b1, b2, min_samples):
    E = res.model
    R, t, n_good = essential.relative_pose_from_essential(E, b1, b2,
                                                          weights=res.inliers.to(E.dtype))
    found = res.found & (res.inliers.sum(-1) > 2.5 * min_samples) & (n_good > 0)
    return RelativePoseInfo(R=R, t=t, essential=E, inliers=res.inliers,
                            threshold_sq=res.threshold_sq, nfa=res.nfa, found=found)


def robust_relative_pose_batch(generators, b1, b2, x1, x2, K1, K2, valid, w2, h2,
                               n_samples=1024, angular=False, precision_sq=math.inf,
                               gumbel=None):
    """robustRelativePose for B pairs at once: b* (B, N, 3) unit bearings,
    x* (B, N, 2) pixels, K* (B, 3, 3), valid (B, N), w2/h2 (B,).  Pinhole
    pairs run 5-point AC-RANSAC with the pixel point-to-line residual
    through F = K2^-T E K1^-1; angular=True runs the 8-point kernel on
    bearings.  Returns RelativePoseInfo with leading dim B."""
    fit, err, s, la0, mult, mm = _essential_kernel(b1, b2, x1, x2, K1, K2, w2, h2, angular)
    res = ransac.ac_ransac(generators, fit, err, (b1, b2), valid, min_samples=s,
                           logalpha0=la0, mult_error=mult, max_models=mm,
                           n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)
    return _relative_pose_info(res, b1, b2, s)


def robust_relative_pose(generator, b1, b2, x1, x2, K1, K2, valid, w2, h2,
                         n_samples=1024, angular=False, precision_sq=math.inf,
                         gumbel=None):
    """One pair (no batch dimension); gumbel (n_samples, N) or None."""
    info = robust_relative_pose_batch(
        [generator], b1[None], b2[None], x1[None], x2[None], K1[None], K2[None],
        valid[None], _one(w2, b1), _one(h2, b1), n_samples=n_samples,
        angular=angular, precision_sq=precision_sq,
        gumbel=None if gumbel is None else gumbel[None])
    return RelativePoseInfo(*[x[0] for x in info])


def robust_relative_pose_adaptive(generators, b1, b2, x1, x2, K1, K2, valid, w2, h2,
                                  round_size=512, max_rounds=8, angular=False,
                                  precision_sq=math.inf, gumbel=None):
    """robustRelativePose through the adaptive-budget AC-RANSAC (the
    MakeInitialPair3D refinement, sequential_SfM.cpp:532), batched like
    robust_relative_pose_batch.  Returns (RelativePoseInfo, n_rounds)."""
    fit, err, s, la0, mult, mm = _essential_kernel(b1, b2, x1, x2, K1, K2, w2, h2, angular)
    res, n_rounds = ransac.ac_ransac_adaptive(
        generators, fit, err, (b1, b2), valid, min_samples=s, logalpha0=la0,
        mult_error=mult, max_models=mm, round_size=round_size, max_rounds=max_rounds,
        precision_sq=precision_sq, gumbel=gumbel)
    return _relative_pose_info(res, b1, b2, s), n_rounds


def _one(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(1)


# ---------------------------------------------------------------------------
# resection (SfM_Localizer::Localize): P3P + pixel or angular NFA
# ---------------------------------------------------------------------------

def _p3p_fit(sub):
    R, t, ok = resection.solve_p3p(*sub)
    return (R, t), ok


def _p3p_pixel_kernel(x2d, K):
    Kf = K[:, None, None, :2, :2]
    Kc = K[:, None, None, :2, 2]

    def err(model, data):
        R, t = model
        Xc = torch.einsum("brij,bnj->brni", R, data[1]) + t[:, :, None, :]
        z = Xc[..., 2:3]
        p = Xc[..., :2] / torch.where(z.abs() < 1e-30, torch.full_like(z, 1e-30), z)
        pix = torch.einsum("...ij,...j->...i", Kf, p) + Kc
        d = pix - x2d[:, None]
        return (d * d).sum(-1)

    return err


def robust_resection_p3p_batch(generators, bearings, x2d, X3d, K, valid, w, h,
                               n_samples=1024, precision_sq=math.inf, gumbel=None):
    """AC-RANSAC P3P for V views at once (ACKernelAdaptorResection_K):
    bearings (V, N, 3), x2d (V, N, 2), X3d (V, N, 3), K (V, 3, 3),
    valid (V, N), w/h (V,).  model = (R (V, 3, 3), t (V, 3)) world->cam."""
    la0 = ransac.logalpha0_point_to_point(w, h, dtype=bearings.dtype).to(bearings.device)
    return ransac.ac_ransac(
        generators, _p3p_fit, _p3p_pixel_kernel(x2d, K), (bearings, X3d), valid,
        min_samples=3, logalpha0=la0, mult_error=ransac.MULT_ERROR_POINT_TO_POINT,
        max_models=4, n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_resection_p3p(generator, bearings, x2d, X3d, K, valid, w, h,
                         n_samples=1024, precision_sq=math.inf, gumbel=None):
    """One view (no batch dimension)."""
    res = robust_resection_p3p_batch(
        [generator], bearings[None], x2d[None], X3d[None], K[None], valid[None],
        _one(w, bearings), _one(h, bearings), n_samples=n_samples,
        precision_sq=precision_sq, gumbel=None if gumbel is None else gumbel[None])
    return ransac.ACRansacResult(*[ransac.tree_map(lambda a: a[0], x) for x in res])


def robust_resection_p3p_adaptive(generators, bearings, x2d, X3d, K, valid, w, h,
                                  round_size=256, max_rounds=8,
                                  precision_sq=math.inf, gumbel=None):
    """Adaptive-budget P3P AC-RANSAC (SfM_Localizer.cpp:109), batched.
    Returns (ACRansacResult, n_rounds)."""
    la0 = ransac.logalpha0_point_to_point(w, h, dtype=bearings.dtype).to(bearings.device)
    return ransac.ac_ransac_adaptive(
        generators, _p3p_fit, _p3p_pixel_kernel(x2d, K), (bearings, X3d), valid,
        min_samples=3, logalpha0=la0, mult_error=ransac.MULT_ERROR_POINT_TO_POINT,
        max_models=4, round_size=round_size, max_rounds=max_rounds,
        precision_sq=precision_sq, gumbel=gumbel)


def robust_resection_p3p_adaptive_single(generator, bearings, x2d, X3d, K, valid, w, h,
                                         **kw):
    """One query (no batch dimension; w, h 0-d tensors): the ACRansacResult
    of robust_resection_p3p_adaptive alone."""
    return _single(lambda *a, **k: robust_resection_p3p_adaptive(*a, **k)[0], generator,
                   bearings, x2d, X3d, K, valid, w, h, **kw)


def robust_resection_angular_batch(generators, bearings, X3d, valid, n_samples=1024,
                                   precision_sq=math.inf, gumbel=None):
    """AC-RANSAC P3P with the angular residual, for non-pinhole views."""
    def err(model, data):
        R, t = model
        d = torch.einsum("brij,bnj->brni", R, data[1]) + t[:, :, None, :]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-30)
        ang = torch.arccos(torch.clamp((d * data[0][:, None]).sum(-1), -1.0, 1.0))
        return ang * ang

    return ransac.ac_ransac(
        generators, _p3p_fit, err, (bearings, X3d), valid, min_samples=3,
        logalpha0=ransac.LOGALPHA0_ANGULAR, mult_error=ransac.MULT_ERROR_ANGULAR,
        max_models=4, n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


def robust_resection_angular(generator, bearings, X3d, valid, n_samples=1024,
                             precision_sq=math.inf, gumbel=None):
    """One view (no batch dimension): the SPHERICAL camera's resection in
    localisation (SfM_Localizer's dispatch for non-pinhole cameras)."""
    return _single(robust_resection_angular_batch, generator, bearings, X3d, valid,
                   n_samples=n_samples, precision_sq=precision_sq, gumbel=gumbel)


# ---------------------------------------------------------------------------
# pose-only refinement (SfM_Localizer::RefinePose, SfM_Localizer.cpp:345)
# ---------------------------------------------------------------------------

def _view_residuals(p6, kind, params, wh, X, xy):
    """One view: p6 (6,), camera row scalars, X (K, 3), xy (K, 2) -> (K, 2)."""
    Xc = so3.rotate(p6[:3], X) + p6[3:]
    return cameras.residual(kind, params, wh[0], wh[1], Xc, xy)


def refine_poses_batch(rotvec, t, kind, params, wh, X, xy, w_obs, iters=8, huber_a=16.0):
    """Pose-only Levenberg-Marquardt for V views at once: each view's own
    2D-3D inliers drive its own 6-parameter LM (Huber a = 16 px^2),
    iters fixed steps.  rotvec/t (V, 3), kind (V,), params (V, 8), wh
    (V, 2), X (V, K, 3), xy (V, K, 2), w_obs (V, K) (0 = padding or
    outlier).  Returns (rotvec, t) refined."""
    from torch.func import jacfwd, vmap

    res_fn = vmap(_view_residuals)
    jac_fn = vmap(jacfwd(_view_residuals))
    V = rotvec.shape[0]
    eye = torch.eye(6, dtype=rotvec.dtype, device=rotvec.device)

    def cost(p6):
        r = res_fn(p6, kind, params, wh, X, xy)
        s = (r * r).sum(-1)
        rho = torch.where(s <= huber_a, s, 2.0 * torch.sqrt(huber_a * torch.clamp(s, min=0.0))
                          - huber_a)
        return 0.5 * (rho * w_obs).sum(-1)

    p6 = torch.cat([rotvec, t], -1)
    lam = torch.full((V,), 1e-4, dtype=rotvec.dtype, device=rotvec.device)
    c = cost(p6)
    for _ in range(iters):
        r = res_fn(p6, kind, params, wh, X, xy)
        J = jac_fn(p6, kind, params, wh, X, xy).to(p6.dtype)  # (V, K, 2, 6)
        s = (r * r).sum(-1)
        wh_ = torch.where(s <= huber_a, torch.ones_like(s),
                          torch.sqrt(huber_a / torch.clamp(s, min=1e-30)))
        w = torch.sqrt(wh_ * torch.clamp(w_obs, min=0.0))
        rw = r * w[..., None]
        Jw = J * w[..., None, None]
        g = -torch.einsum("vkab,vka->vb", Jw, rw)
        H = torch.einsum("vkab,vkac->vbc", Jw, Jw)
        dH = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12)
        Hd = H + lam[:, None, None] * torch.diag_embed(dH) + 1e-12 * eye
        p6_new = p6 + linalg.solve(Hd, g)
        c_new = cost(p6_new)
        accept = c_new < c
        p6 = torch.where(accept[:, None], p6_new, p6)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        c = torch.where(accept, c_new, c)
    return p6[:, :3], p6[:, 3:]
