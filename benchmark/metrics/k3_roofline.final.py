"""K3's share of its roofline over a BAL window's CG matvecs, for a
problem without a group table (K3 plans from the rows' points and reads
no table): bounds.smatvec_bound_ms at the solved problem's layout (slots,
rows, points, a table of width 0, poses, intrinsics), once for each call
the program counts in ba.cg_k3, over the device time of K3's two launches
(smatvec_tiles, smatvec_camera_sums) in the profiler's trace.  None for a
program that does not count ba.cg_k3, or where K3 did not launch."""

from benchmark import bounds, program_trace

K3_KERNELS = ("smatvec_tiles", "smatvec_camera_sums")


def read(ctx):
    tr, p = ctx.get("trace"), getattr(ctx.get("state"), "p0", None)
    recs = program_trace.program_records()
    if tr is None or p is None or p.pt_obs is None or recs is None:
        return None
    calls = recs["counters"].get("ba.cg_k3")
    dev_s = tr.kernel_s(*K3_KERNELS)
    if not calls or dev_s <= 0:
        return None
    bound_ms = bounds.smatvec_bound_ms(p.obs_pose.shape[0], p.pt_obs.row_point.shape[0],
                                       p.X.shape[0], 0, p.rotvec.shape[0],
                                       p.intr_params.shape[0])
    return 100.0 * calls * bound_ms * 1e-3 / dev_s
