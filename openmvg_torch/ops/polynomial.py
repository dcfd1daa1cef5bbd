"""Fixed-shape real-root finding for low-degree polynomials (counterpart:
openmvg_tpu/ops/polynomial.py).

Every sign change of p is bracketed on a tan-warped grid over the Cauchy
bound and polished by a fixed number of bisections: batched, static
shapes, no companion-matrix eigensolver.  Even-multiplicity roots do not
change sign and are skipped (measure-zero tangencies in RANSAC).
"""

import math

import torch


def polyval(coeffs, x):
    """sum_i coeffs[..., i] * x^i (lowest degree first), Horner."""
    n = coeffs.shape[-1]
    acc = coeffs[..., n - 1]
    for i in range(n - 2, -1, -1):
        acc = acc * x + coeffs[..., i]
    return acc


def cauchy_bound(coeffs, eps=1e-12):
    """1 + max |a_i| / |a_lead|, the leader being the highest coefficient
    that is not negligible (a degenerate polynomial keeps a finite bound)."""
    n = coeffs.shape[-1]
    mags = coeffs.abs()
    scale = mags.max(dim=-1, keepdim=True).values
    sig = mags > eps * torch.clamp(scale, min=1e-300)
    idx = torch.arange(n, device=coeffs.device)
    lead_idx = torch.where(sig, idx, -1).max(dim=-1).values
    lead = torch.gather(mags, -1, lead_idx.clamp(min=0)[..., None])[..., 0]
    bound = 1.0 + mags.max(dim=-1).values / torch.clamp(lead, min=1e-300)
    return torch.where(lead_idx <= 0, torch.ones_like(bound), bound)


def real_roots(coeffs, max_roots, n_grid=256, n_bisect=64):
    """Odd-multiplicity real roots of p (coeffs lowest first, (..., D+1)).

    Returns (roots (..., max_roots), valid (..., max_roots) bool), the
    first max_roots brackets in ascending grid order."""
    dt, dev = coeffs.dtype, coeffs.device
    bound = cauchy_bound(coeffs)[..., None]
    t = torch.linspace(-1.0, 1.0, n_grid, dtype=dt, device=dev)
    warp = torch.tan(t * (math.pi / 4)) / torch.tan(
        torch.tensor(math.pi / 4, dtype=dt, device=dev))
    xs = bound * warp
    vals = polyval(coeffs[..., None, :], xs)
    sign = torch.sign(vals)
    sign = torch.where(sign == 0, -torch.ones_like(sign), sign)
    flips = sign[..., :-1] * sign[..., 1:] < 0
    order = torch.cumsum(flips.to(torch.int64), dim=-1) - 1
    slot = torch.where(flips, order, max_roots)
    onehot = (slot[..., None] == torch.arange(max_roots, device=dev)).to(dt)
    lo = torch.einsum("...gm,...g->...m", onehot, xs[..., :-1])
    hi = torch.einsum("...gm,...g->...m", onehot, xs[..., 1:])
    valid = flips.sum(dim=-1, keepdim=True) > torch.arange(max_roots, device=dev)
    f_lo = polyval(coeffs[..., None, :], lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = polyval(coeffs[..., None, :], mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
        f_lo = torch.where(same, f_mid, f_lo)
    roots = 0.5 * (lo + hi)
    return torch.where(valid, roots, torch.zeros_like(roots)), valid


def real_roots_split(coeffs, max_roots, n_grid=256, n_bisect=64):
    """Odd-multiplicity real roots of p at every scale: the roots in
    [-1, 1] from p on a uniform grid, the roots outside from the reversed
    polynomial w^D p(1/w) on (-1, 1), each polished by bisection.

    real_roots spreads one grid over the Cauchy bound, which grows as the
    leading coefficient shrinks; then two roots near zero share a cell and
    are both lost.  The 5-point solver met this on a third of random
    problems (its degree-10 det B(z) often has a small leading
    coefficient).  Here both halves keep the same relative resolution.
    Returns (roots (..., max_roots), valid), valid roots first."""
    dt, dev = coeffs.dtype, coeffs.device
    xs = torch.linspace(-1.0, 1.0, n_grid, dtype=dt, device=dev)
    lead = coeffs.shape[:-1]
    xs = xs.expand(lead + (n_grid,))
    r_in, v_in = _bracket_and_bisect(coeffs, xs, max_roots, n_bisect)
    r_out, v_out = _bracket_and_bisect(coeffs.flip(-1), xs, max_roots, n_bisect)
    v_out = v_out & (r_out.abs() < 1.0) & (r_out != 0)
    r_out = 1.0 / torch.where(v_out, r_out, torch.ones_like(r_out))
    roots = torch.cat([r_in, r_out], -1)
    valid = torch.cat([v_in, v_out], -1)
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices[..., :max_roots]
    roots = torch.gather(roots, -1, order)
    valid = torch.gather(valid, -1, order)
    return torch.where(valid, roots, torch.zeros_like(roots)), valid


def _bracket_and_bisect(coeffs, xs, max_roots, n_bisect):
    """The first max_roots sign changes of p over the grid xs (..., G),
    each bisected n_bisect times."""
    dev = coeffs.device
    vals = polyval(coeffs[..., None, :], xs)
    sign = torch.sign(vals)
    sign = torch.where(sign == 0, -torch.ones_like(sign), sign)
    flips = sign[..., :-1] * sign[..., 1:] < 0
    order = torch.cumsum(flips.to(torch.int64), dim=-1) - 1
    slot = torch.where(flips, order, max_roots)
    onehot = (slot[..., None] == torch.arange(max_roots, device=dev)).to(coeffs.dtype)
    lo = torch.einsum("...gm,...g->...m", onehot, xs[..., :-1])
    hi = torch.einsum("...gm,...g->...m", onehot, xs[..., 1:])
    valid = flips.sum(dim=-1, keepdim=True) > torch.arange(max_roots, device=dev)
    f_lo = polyval(coeffs[..., None, :], lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = polyval(coeffs[..., None, :], mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
        f_lo = torch.where(same, f_mid, f_lo)
    return 0.5 * (lo + hi), valid


def polymul(a, b, out_len=None):
    """Product of coefficient vectors (lowest first), cut to out_len."""
    la, lb = a.shape[-1], b.shape[-1]
    n = la + lb - 1 if out_len is None else out_len
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    terms = [[] for _ in range(n)]
    for i in range(la):
        for j in range(lb):
            if i + j < n:
                terms[i + j].append(a[..., i] * b[..., j])
    zero = torch.zeros(lead, dtype=a.dtype, device=a.device)
    return torch.stack([sum(t, zero) if t else zero for t in terms], -1)
