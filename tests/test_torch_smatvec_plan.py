"""Kernel K3's plan and first launch on the CPU: the tile plan
(openmvg_torch/ops/smatvec.py::tile_plan), the layout check it makes, and
the plain version of the launch that writes e (smatvec_e_plain), which K2's
camera sums turn into the whole matvec.  The kernel itself runs only on the
card (tests/test_torch_smatvec_cuda.py, whose layouts these tests share).
"""

import numpy as np
import pytest
import torch

from openmvg_torch.ops import seg_sum as k2
from openmvg_torch.ops import smatvec as k3
from tests.test_torch_smatvec_cuda import k3_case

# name, poses, intrinsics, slots a row, points, most observations a point, kind
LAYOUTS = [
    ("P1_I1_R4", 1, 1, 4, 300, 6, None),
    ("P7_I2_R8_tracks_1_40", 7, 2, 8, 600, 40, None),
    ("P9_I2_R16", 9, 2, 16, 200, 50, None),
    ("P20_I3_R32", 20, 3, 32, 150, 70, None),
    ("P5_I1_R4_one_point", 5, 1, 4, 1, 3000, "one"),
    ("P6_I2_R8_hub_among_tracks", 6, 2, 8, 300, 12, "hub"),
]
IDS = [c[0] for c in LAYOUTS]


def _layout(P, I, R, L, max_obs, kind, seed=0):
    return [torch.as_tensor(a) for a in k3_case(P, I, R, L, max_obs, kind, seed)]


def _check_tiles(pt_row0, tiles, L1, R, tile):
    off, t = pt_row0.numpy(), tiles.numpy()
    L = off.shape[0] - 1
    assert t.shape[1] == 4 and t.shape[0] >= 1
    # the tiles cover the rows [0, L1) and the points [0, L) in order, each
    # point in exactly one tile
    assert t[0, 0] == 0 and t[-1, 1] == L1 and (t[1:, 0] == t[:-1, 1]).all()
    assert t[0, 2] == 0 and t[-1, 3] == L and (t[1:, 2] == t[:-1, 3]).all()
    assert (t[:, 3] > t[:, 2]).all()
    # tiles start and end at point boundaries
    assert (t[:, 0] == off[t[:, 2]]).all() and (t[:, 1] == off[t[:, 3]]).all()
    # a tile holds at most `tile` slots, unless it is one point larger than that
    slots = (t[:, 1] - t[:, 0]) * R
    big = slots > tile
    assert (t[big, 3] - t[big, 2] == 1).all()
    # every point larger than a tile sits alone in its tile
    sizes = (off[1:] - off[:-1]) * R
    owner = np.repeat(np.arange(t.shape[0]), t[:, 3] - t[:, 2])
    for l in np.nonzero(sizes > tile)[0]:
        j = owner[l]
        assert t[j, 2] == l and t[j, 3] == l + 1
    # greedy: the next tile's first point would not have fitted
    nxt = t[1:, 2]
    assert ((t[:-1, 1] - t[:-1, 0]) * R + sizes[nxt] > tile).all()


@pytest.mark.parametrize("tile", [k3.TILE, 64])
@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", LAYOUTS, ids=IDS)
def test_tile_plan_cuts_at_point_boundaries(name, P, I, R, L, max_obs, kind, tile):
    args = _layout(P, I, R, L, max_obs, kind)
    row_point, groups = args[8], args[9]
    pt_row0, tiles = k3.tile_plan(row_point, groups.shape[0], args[0].shape[0], tile)
    assert pt_row0.dtype == torch.int32 and tiles.dtype == torch.int32
    rows = np.bincount(row_point.numpy(), minlength=L)
    assert np.array_equal(np.diff(pt_row0.numpy()), rows)
    _check_tiles(pt_row0, tiles, row_point.shape[0], R, tile)


def test_tile_plan_of_more_points_than_one_tile():
    """R 8, tracks of 1-40 slots, thousands of points: many tiles, each
    filled close to the tile size."""
    args = _layout(7, 2, 8, 4000, 40, None)
    pt_row0, tiles = k3.tile_plan(args[8], args[9].shape[0], args[0].shape[0])
    t = tiles.numpy()
    slots = (t[:, 1] - t[:, 0]) * 8
    assert t.shape[0] >= args[0].shape[0] // k3.TILE
    assert (slots[:-1] > k3.TILE - 40 - 8).all() and (slots <= k3.TILE).all()


def _broken_tables():
    """(name, row_point, groups, slots): tables the kernel must refuse.
    The plan reads row_point and the point count (groups' rows) alone; each
    table's group table is broken as its row_point is, for the host plan,
    which reads both."""
    base = _layout(4, 1, 4, 50, 9, None)
    rp, g, O = base[8], base[9], base[0].shape[0]
    L1 = rp.shape[0]
    out = []
    # the reference's padded test layout: rows of no point, sentinel < L1
    rp2 = torch.cat([rp, torch.full((2,), 50, dtype=rp.dtype)])
    g2 = torch.where(g >= L1, torch.full_like(g, L1), g)
    out.append(("padding_rows", rp2, g2, O + 8))
    # the first row of point 1 before the last row of point 0
    multi = int(torch.nonzero((g < L1).sum(1) > 1)[0, 0])
    r = int(g[multi + 1, 0])
    rp3, g3 = rp.clone(), g.clone()
    rp3[[r - 1, r]] = rp3[[r, r - 1]]
    g3[multi + 1, 0], g3[multi, int((g[multi] < L1).sum()) - 1] = r - 1, r
    out.append(("rows_out_of_order", rp3, g3, O))
    # a point's run of rows broken by another point's row
    rp4, g4 = rp.clone(), g.clone()
    rp4[int(g[multi, 0])] = multi + 1
    g4[multi, 0] = L1
    out.append(("sentinel_inside_a_run", rp4, g4, O))
    # row_point disagrees with the group table
    rp5 = rp.clone()
    rp5[0] = 1
    out.append(("row_point_disagrees", rp5, g, O))
    # three slots a row (not a power of two) and 64 (over a warp)
    out.append(("three_slots_a_row", rp, g, 3 * L1))
    out.append(("sixty_four_slots_a_row", rp, g, 64 * L1))
    # a point with no row
    g7 = torch.cat([g, torch.full((1, g.shape[1]), L1, dtype=g.dtype)])
    out.append(("point_without_rows", rp, g7, O))
    return out


@pytest.mark.parametrize("case", range(7), ids=[c[0] for c in _broken_tables()])
def test_tile_plan_refuses_other_layouts(case):
    name, rp, g, O = _broken_tables()[case]
    with pytest.raises(ValueError):
        k3.tile_plan(rp, g.shape[0], O)
    with pytest.raises(ValueError):
        k3.smatvec_plan(torch.zeros(O, dtype=torch.int32), torch.zeros(O, dtype=torch.int32),
                        rp, g.shape[0], 4, 1)


def _host_tile_plan(row_point, groups, n_slots, tile=k3.TILE):
    """The tile plan as the host once made it, from a copy of the whole
    group table checked in numpy: the yardstick of tile_plan, which
    checks on the device and reads back only the points' first rows.
    Returns (pt_row0, tiles) as int64 arrays, or None for a table of
    another form."""
    L1 = row_point.shape[0]
    if groups.dim() != 2 or L1 == 0 or n_slots % L1:
        return None
    R = n_slots // L1
    if R > 32 or R & (R - 1):
        return None
    L, M = groups.shape
    g = groups.cpu().numpy().astype(np.int64)
    rp = row_point.cpu().numpy().astype(np.int64)
    inside = (g >= 0) & (g < L1)
    n = inside.sum(1)
    off = np.zeros(L + 1, np.int64)
    np.cumsum(n, out=off[1:])
    col = np.arange(M)
    if not (np.array_equal(inside, col < n[:, None]) and bool((n >= 1).all())
            and off[-1] == L1
            and np.array_equal(np.where(inside, g, 0), np.where(inside, off[:-1, None] + col, 0))
            and np.array_equal(rp, np.repeat(np.arange(L), n))):
        return None
    ends = off[1:] * R
    tiles = []
    l = 0
    while l < L:
        l2 = max(int(np.searchsorted(ends, off[l] * R + tile, side="right")), l + 1)
        tiles.append((off[l], off[l2], l, l2))
        l = l2
    return off, np.asarray(tiles, np.int64).reshape(-1, 4)


@pytest.mark.parametrize("tile", [k3.TILE, 64])
@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", LAYOUTS, ids=IDS)
def test_tile_plan_equals_the_host_plan(name, P, I, R, L, max_obs, kind, tile):
    """The device-checked plan gives the host plan's first rows and tiles,
    points wider than a tile among them, and both refuse every malformed
    table."""
    args = _layout(P, I, R, L, max_obs, kind, seed=R)
    rp, g, O = args[8], args[9], args[0].shape[0]
    pt_row0, tiles = k3.tile_plan(rp, g.shape[0], O, tile)
    ref = _host_tile_plan(rp, g, O, tile)
    assert ref is not None
    assert np.array_equal(pt_row0.numpy(), ref[0])
    assert np.array_equal(tiles.numpy(), ref[1])
    if kind is not None:
        assert int(np.diff(ref[0]).max()) * R > tile           # a point wider than a tile
    for _, brp, bg, bO in _broken_tables():
        assert _host_tile_plan(brp, bg, bO, tile) is None
        with pytest.raises(ValueError):
            k3.tile_plan(brp, bg.shape[0], bO, tile)


def _f64(args):
    return [a.double() if a.is_floating_point() else a for a in args]


@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", LAYOUTS, ids=IDS)
def test_e_then_camera_sums_is_smatvec_plain(name, P, I, R, L, max_obs, kind):
    """The kernel's split: e from the first launch, K2's camera_jtu of e
    from the second, equals the plain matvec in float64 within 1e-12; the
    pose without observations gets zeros."""
    d = _f64(_layout(P, I, R, L, max_obs, kind, seed=P + R))
    O = d[0].shape[0]
    e = k3.smatvec_e_plain(*d)
    assert e.shape == (O, 2) and e.dtype == torch.float64
    got = k2.camera_jtu_plain(d[0].reshape(O, 2, 6), d[1].reshape(O, 2, 8), e, d[3], d[4],
                              P, I)
    ref = k3.smatvec_plain(*d)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-12 * (1 + float(b.abs().max()))
    if P > 1:
        assert bool((ref[0][P // 2] == 0).all())
    mag = k3.smatvec_e_magnitudes(*d)
    assert bool((e.abs() <= mag * (1 + 1e-12)).all())


@pytest.mark.parametrize("tile", [k3.TILE, 64])
@pytest.mark.parametrize("name,P,I,R,L,max_obs,kind", LAYOUTS, ids=IDS)
def test_each_tile_finishes_its_points_alone(name, P, I, R, L, max_obs, kind, tile):
    """What one block of the first launch sees: a tile's slots, point
    blocks and v.  e computed tile by tile from those alone (rows summed in
    row order into their point) equals smatvec_e_plain."""
    d = _f64(_layout(P, I, R, L, max_obs, kind, seed=1))
    jp, ji, jx, pose, intr, vp, vi, hinv, rp, g = d
    O = jp.shape[0]
    pt_row0, tiles = k3.tile_plan(rp, g.shape[0], O, tile)
    u = (jp.reshape(O, 2, 6) * vp[pose.long()][:, None]).sum(-1) + \
        (ji.reshape(O, 2, 8) * vi[intr.long()][:, None]).sum(-1)
    jx3 = jx.reshape(O, 2, 3)
    e = torch.empty((O, 2), dtype=torch.float64)
    off = pt_row0.long()
    for r0, r1, l0, l1 in tiles.long().tolist():
        s = slice(r0 * R, r1 * R)
        rows = (jx3[s] * u[s][:, :, None]).sum(1).reshape(r1 - r0, R, 3).sum(1)
        for l in range(l0, l1):
            y = hinv[l] @ rows[off[l] - r0:off[l + 1] - r0].sum(0)
            t = slice(int(off[l]) * R, int(off[l + 1]) * R)
            e[t] = u[t] - (jx3[t] * y).sum(-1)
    ref = k3.smatvec_e_plain(*d)
    assert float((e - ref).abs().max()) <= 1e-12 * (1 + float(ref.abs().max()))


def test_plan_on_the_cpu_holds_no_scratch():
    args = _layout(4, 1, 8, 100, 20, None)
    plan = k3.smatvec_plan(args[3], args[4], args[8], 100, 4, 1)
    assert plan.e is None and plan.tables is None
    assert plan.tiles.shape[1] == 4 and plan.pt_row0.shape == (101,)
    got = k3.smatvec(*args, plan=plan)
    ref = k3.smatvec_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
