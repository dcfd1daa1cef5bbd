"""Reductions the per-layer metrics share.  Each reader gets the run's
context: rec (trace.Recorder: spans, counters, kernel calls), trace
(trace.DeviceTrace, None off the card) and out (the window's summary)."""

from benchmark import bounds

K1_KERNELS = ("two_nn_u8_kernel", "two_nn_f32_kernel")
# camera_sums_kernel<T, MODE>; K3's smatvec_camera_sums does not match
K2_KERNELS = ("seg_sum_kernel", "camera_sums_kernel")


def mean(values):
    return sum(values) / len(values) if values else None


def per_unit_spans(ctx, *names):
    """The mean over the window's units of the summed seconds of spans
    with these names; None without units."""
    rec = ctx["rec"]
    if not rec.units:
        return None
    sums = [0.0] * rec.units
    for n in names:
        for u, s in enumerate(rec.span_sums(n)):
            sums[u] += s
    return mean(sums)


def per_unit_counter(ctx, name):
    c = ctx["rec"].counters.get(name)
    return mean(c[:ctx["rec"].units]) if c else None


def device_idle(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def k1_bound_ms(ctx):
    total = 0.0
    for c in ctx["rec"].calls.get("k1", ()):
        na = c["counts_a"].long()[c["pairs"][:, 0].long()]
        nb = c["counts_b"].long()[c["pairs"][:, 1].long()]
        total += bounds.two_nn_bound_ms(float((na * nb).sum()), c["D"], c["desc_bytes"],
                                        c["n_counts"], c["pairs"].shape[0], c["out_elems"],
                                        c["int8"])
    return total


def k2_bound_ms(ctx):
    total = 0.0
    for kind, O, a, b, itemsize in ctx["rec"].calls.get("k2", ()):
        total += (bounds.seg_sum_bound_ms(O, a, b, itemsize) if kind == "seg_sum"
                  else bounds.camera_bound_ms(O, a, b, kind, itemsize))
    return total


def roofline(ctx, bound_ms, kernels):
    """100 x the least time of the window's launches over their device
    time; None when the trace holds none of them."""
    tr = ctx["trace"]
    if tr is None:
        return None
    dev_s = tr.kernel_s(*kernels)
    if dev_s <= 0:
        return None
    return 100.0 * bound_ms(ctx) * 1e-3 / dev_s
