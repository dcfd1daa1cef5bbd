"""K3's share of its roofline over a BAL window's CG matvecs:
bounds.smatvec_bound_ms at the solved problem's layout (slots, rows,
points, the group table's width, poses, intrinsics), once for each call
the program counts in ba.cg_k3, over the device time of K3's two launches
(smatvec_tiles, smatvec_camera_sums) in the profiler's trace.  None for a
program that does not count ba.cg_k3, or where K3 did not launch."""

from benchmark import bounds, program_trace

K3_KERNELS = ("smatvec_tiles", "smatvec_camera_sums")


def read(ctx):
    tr, p = ctx.get("trace"), getattr(ctx.get("state"), "p0", None)
    recs = program_trace.program_records()
    if tr is None or p is None or p.pt_obs is None or p.pt_obs.groups is None or recs is None:
        return None
    calls = recs["counters"].get("ba.cg_k3")
    dev_s = tr.kernel_s(*K3_KERNELS)
    if not calls or dev_s <= 0:
        return None
    t = p.pt_obs
    L, M = t.groups.shape
    bound_ms = bounds.smatvec_bound_ms(p.obs_pose.shape[0], t.row_point.shape[0], L, M,
                                       p.rotvec.shape[0], p.intr_params.shape[0])
    return 100.0 * calls * bound_ms * 1e-3 / dev_s
