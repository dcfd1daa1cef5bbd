"""Wrappers the benchmark puts around the program's calls in a traced
run, from its own files: a span around each bundle adjustment
(sfm.ba.adjust, which ends in a host read, so the span holds its device
work), a count of LM steps (sfm.ba.lm_step, which adjust looks up in its
module), and the shapes of each launch of kernels K1 and K2 (their
wrappers' module-level launch functions, recorded only when the
module's LAUNCHES counter shows that the call launched).  The
untraced run installs none of them.
"""

import contextlib


@contextlib.contextmanager
def installed(rec):
    """Install every wrapper for the block; restore the originals after."""
    from openmvg_torch.ops import seg_sum as k2
    from openmvg_torch.ops import two_nn as k1
    from openmvg_torch.sfm import ba

    saved = [(ba, "adjust", ba.adjust), (ba, "lm_step", ba.lm_step),
             (k1, "_launch", k1._launch), (k2, "seg_sum", k2.seg_sum),
             (k2, "_camera", k2._camera)]
    orig_adjust, orig_step = ba.adjust, ba.lm_step
    orig_launch, orig_seg, orig_cam = k1._launch, k2.seg_sum, k2._camera

    def adjust(*a, **kw):
        with rec.span("ba.adjust"):
            return orig_adjust(*a, **kw)

    def lm_step(*a, **kw):
        rec.count("lm_steps")
        return orig_step(*a, **kw)

    def launch(da, db, pairs, counts_a, counts_b, valid_b, n_out):
        n0 = k1.LAUNCHES
        out = orig_launch(da, db, pairs, counts_a, counts_b, valid_b, n_out)
        if k1.LAUNCHES > n0:
            # the device tensors are kept; the products are summed after the window
            rec.call("k1", dict(pairs=pairs.clone(), counts_a=counts_a.clone(),
                                counts_b=counts_b.clone(), D=da.shape[2],
                                desc_bytes=da.numel() * da.element_size()
                                + (0 if db is da else db.numel() * db.element_size()),
                                n_counts=counts_a.numel() + (0 if counts_b is counts_a
                                                             else counts_b.numel()),
                                out_elems=pairs.shape[0] * n_out,
                                int8=da.element_size() == 1))
        return out

    def seg_sum(vals, ids, num, plan=None):
        n0 = k2.LAUNCHES
        out = orig_seg(vals, ids, num, plan)
        if k2.LAUNCHES > n0:
            rec.call("k2", ("seg_sum", vals.shape[0], vals.shape[1], num,
                            vals.element_size()))
        return out

    def camera(mode, Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr, plans):
        n0 = k2.LAUNCHES
        out = orig_cam(mode, Jp6, Ji8, u, pose_ids, intr_ids, n_pose, n_intr, plans)
        if k2.LAUNCHES > n0:
            rec.call("k2", ("jtu" if mode == 0 else "jtj", Jp6.shape[0], n_pose, n_intr,
                            Jp6.element_size()))
        return out

    ba.adjust, ba.lm_step = adjust, lm_step
    k1._launch, k2.seg_sum, k2._camera = launch, seg_sum, camera
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
