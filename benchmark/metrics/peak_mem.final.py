"""Peak device memory of the traced window, as a share of the card's
memory: torch.cuda.max_memory_allocated, whose peak the harness resets as
the window starts, over the card's total memory.  The window's solves are
alike, so this is a solve's peak.  None off the card."""


def read(ctx):
    torch = ctx.get("torch")
    if ctx.get("trace") is None or torch is None:
        return None
    return 100.0 * torch.cuda.max_memory_allocated() / torch.cuda.get_device_properties(
        0).total_memory
