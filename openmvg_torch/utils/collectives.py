"""The one collective the bundle adjuster needs, below both sfm/ and
parallel/ (parallel/mesh.py re-exports it beside the others).

Under gloo, which carries only CPU tensors, a CUDA tensor is staged
through a host buffer here, in the open: a copy to the host, the
collective, a copy back.
"""

import torch.distributed as dist


def is_gloo(group):
    """True when `group` runs over gloo."""
    return dist.get_backend(group) == "gloo"


def all_reduce(t, group):
    """Sum of `t` over the group, returned on t's device (a new tensor
    when staged through the host under gloo)."""
    if t.is_cuda and is_gloo(group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(t, group=group)
    return t
