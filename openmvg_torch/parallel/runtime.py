"""Multi-rank runtime bring-up on torch.distributed (counterpart:
openmvg_tpu/parallel/runtime.py).

One process a rank (SPMD), each with an explicit device.  Usage, once per
process before any collective:

    from openmvg_torch.parallel import runtime
    rank, device, world = runtime.initialize()
    mesh = runtime.global_mesh()

Arguments come first, then the reference's variables (OMT_COORDINATOR,
OMT_NUM_PROCESSES, OMT_PROCESS_ID), then torchrun's (MASTER_ADDR /
MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE).  The
coordinator is "host:port", a tcp:// or a file:// URL (a FileStore, which
needs no port).

The backend is NCCL when every rank of a node has a card of its own, and
gloo on the CPU.  NCCL does not put two ranks of one communicator on one
card, so when the ranks of a node outnumber its cards initialize raises,
unless gloo is named (backend="gloo" or OMT_DIST_BACKEND=gloo): then the
ranks share the cards, their tensors stay on them, and gloo carries the
collectives through host buffers (mesh.py).  gloo is never picked
quietly for CUDA, and a CUDA device without a card raises.

spawn(fn, n, ...) starts n ranks with torch.multiprocessing's spawn start
method (a forked child cannot initialise CUDA again), joins them through a
FileStore in a fresh temporary directory, and returns each rank's result;
a rank that raises, dies or outlives the timeout makes spawn raise.
"""

import contextlib
import datetime
import io
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from openmvg_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")
SPAWN_TIMEOUT = 600.0   # seconds a spawned group may run, unless its caller says otherwise
_STATE = None   # (rank, device, world) once initialize has run here


def _env_int(*names):
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def _init_method(coordinator):
    if coordinator is None:
        return None
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def pick_backend(device, local_ranks, backend=None):
    """The backend for `local_ranks` ranks of a node on `device`: the named
    one (argument, else OMT_DIST_BACKEND) when it can run, NCCL for CUDA
    with a card a rank, gloo for the CPU.  Raises where NCCL cannot run."""
    backend = backend or os.environ.get("OMT_DIST_BACKEND") or None
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; choose one of {BACKENDS}")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices; the CPU takes gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if local_ranks > cards:
        raise RuntimeError(
            f"{local_ranks} ranks on a node with {cards} CUDA card(s): NCCL puts one "
            "rank on a card; name gloo (backend='gloo' or OMT_DIST_BACKEND=gloo) to "
            "let ranks share a card, or run fewer ranks")
    return "nccl"


def initialize(coordinator=None, num_processes=None, process_id=None, backend=None,
               device=None, local_rank=None, timeout=1800.0):
    """Join the process group (idempotent).  Returns (rank, local device,
    world size).  `device` is "cuda" (the default) or "cpu"; a CUDA rank
    takes card local_rank modulo the card count."""
    global _STATE
    if _STATE is not None:
        return _STATE
    if dist.is_initialized():
        _STATE = (dist.get_rank(), _default_device(device, dist.get_rank()),
                  dist.get_world_size())
        return _STATE
    coordinator = coordinator or os.environ.get("OMT_COORDINATOR") or (
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT") else None)
    world = num_processes if num_processes is not None else (
        _env_int("OMT_NUM_PROCESSES", "WORLD_SIZE") or 1)
    rank = process_id if process_id is not None else (
        _env_int("OMT_PROCESS_ID", "RANK") or 0)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or world
    dev = resolve_device(device)
    be = pick_backend(dev, local_ranks, backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if coordinator is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a coordinator")
        coordinator = _fresh_store()
    dist.init_process_group(be, init_method=_init_method(coordinator), world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    _STATE = (rank, dev, world)
    return _STATE


_STORES = []    # temporary directories of this process's FileStores


def _fresh_store():
    """A FileStore URL in a new temporary directory (removed by shutdown)."""
    _STORES.append(tempfile.mkdtemp(prefix="omt_dist_"))
    return "file://" + os.path.join(_STORES[-1], "store")


def _default_device(device, rank):
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def launched_world(device=None):
    """(rank, world size) of the world this process was started in: its
    process group, or the launcher's variables (OMT_NUM_PROCESSES or
    WORLD_SIZE above 1, then initialize joins it on `device`); (0, 1) for
    a process started alone."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if (_env_int("OMT_NUM_PROCESSES", "WORLD_SIZE") or 1) > 1:
        rank, _, world = initialize(device=device)
        return rank, world
    return 0, 1


@contextlib.contextmanager
def joined(device=None):
    """The world of a CLI command: the one it was launched in, or a world of
    one made for the command and left after it.  Yields (rank, world)."""
    own = launched_world(device) == (0, 1) and not dist.is_initialized()
    initialize(_fresh_store() if own else None, device=device)   # no-op once joined
    try:
        yield dist.get_rank(), dist.get_world_size()
    finally:
        if own:
            shutdown()


def ranks_for(asked, device):
    """(ranks, backend) for a command asking for `asked` ranks on `device`:
    all of them over gloo on the CPU or when gloo is named (ranks share
    the cards), else one a card over NCCL, at most the card count."""
    be = pick_backend(device, 1, None)
    if be == "gloo":
        return asked, "gloo"
    return min(asked, torch.cuda.device_count()), "nccl"


def run_ranks(fn, n, device=None, backend=None, args=(), timeout=SPAWN_TIMEOUT):
    """fn(rank, n, *args) on n ranks: spawned, or for one rank a world of
    one in this process (left after fn).  Returns the results in rank
    order.  timeout: seconds (spawn only)."""
    if n == 1 and not dist.is_initialized():
        initialize(_fresh_store(), 1, 0, backend=backend, device=device)
        try:
            return [fn(0, 1, *args)]
        finally:
            shutdown()
    return spawn(fn, n, device=device, backend=backend, args=args, timeout=timeout)


def local_device():
    """This rank's device (initialize's choice)."""
    if _STATE is None:
        raise RuntimeError("runtime.initialize has not run in this process")
    return _STATE[1]


def shutdown():
    """Leave the process group (the next initialize joins a new one)."""
    global _STATE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None
    while _STORES:
        shutil.rmtree(_STORES.pop(), ignore_errors=True)


def global_mesh():
    """Mesh of every rank of the world (every rank calls it)."""
    from openmvg_torch.parallel.mesh import make_mesh

    return make_mesh()


class HybridMesh(NamedTuple):
    shape: tuple      # (nodes, local ranks)
    local: object     # Mesh of this node's ranks
    across: object    # Mesh of the ranks with this local rank on every node


def hybrid_mesh():
    """The world as (nodes, local ranks): a Mesh within this node and one
    across nodes; (1, n) on one node.  Every rank calls it."""
    from openmvg_torch.parallel.mesh import Mesh

    world, me = dist.get_world_size(), dist.get_rank()
    per = _env_int("LOCAL_WORLD_SIZE") or world
    if world % per:
        raise ValueError(f"a world of {world} is not whole nodes of {per} ranks")
    nodes = world // per
    dev = local_device()

    def groups(rank_lists):
        mine = None
        for ranks in rank_lists:
            g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            if me in ranks:
                mine = Mesh(group=g, ranks=tuple(ranks), rank=ranks.index(me), device=dev)
        return mine

    local = groups([list(range(n * per, (n + 1) * per)) for n in range(nodes)])
    across = groups([list(range(r, world, per)) for r in range(per)])
    return HybridMesh(shape=(nodes, per), local=local, across=across)


def replicate_to_global(x, mesh, shard=False):
    """A host value held alike by every rank -> this rank's tensor on the
    mesh: the whole value broadcast from mesh rank 0, or (shard=True) this
    rank's contiguous rows of it."""
    from openmvg_torch.parallel import mesh as meshlib

    x = torch.as_tensor(x)
    if shard:
        return meshlib.shard_rows(x, mesh)
    return meshlib.broadcast(x.to(mesh.device), mesh)


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, n, init, device, backend, threads, timeout, args, results):
    try:
        torch.set_num_threads(threads)
        initialize(init, n, rank, backend=backend, device=device, local_rank=rank,
                   timeout=timeout)
        out = fn(rank, n, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)   # peers may be blocked in a collective: no orderly exit
    # pickled here, by value: through the queue, torch would pass a tensor
    # as a handle into this process, which is gone by the time it is read
    results.put((rank, True, pickle.dumps(out)))
    shutdown()


def spawn(fn, n, device=None, backend=None, args=(), timeout=SPAWN_TIMEOUT, threads=None,
          store=None):
    """Run fn(rank, n, *args) on n ranks, one spawned process each, joined
    in one process group on `device` ("cuda" by default, or "cpu") with
    `backend` (pick_backend's rule).  Returns the n results in rank order.
    Raises when a rank raises or exits without a result, or when the ranks
    outlive `timeout` seconds; every process is gone when it returns.
    `store`: a directory for the FileStore (default: a new temporary one,
    removed after).  CUDA kernels are built here first, so the ranks do not
    race to build them."""
    dev = resolve_device(device)
    pick_backend(dev, n, backend)           # raise here, not in n children
    if dev.type == "cuda":
        from openmvg_torch.ops import seg_sum, two_nn

        two_nn.build()
        seg_sum.build()
    ctx = torch.multiprocessing.get_context("spawn")
    if store is None:
        init = _fresh_store()
    else:
        os.makedirs(store, exist_ok=True)
        init = "file://" + os.path.join(store, "store")
    results = ctx.Queue()
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, init, str(dev.type), backend, threads, timeout,
                               args, results))
             for r in range(n)]
    out, deadline = {}, time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(out)} of {n} ranks still running after "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    time.sleep(0.5)     # let a failing rank's report arrive
                    if results.empty():
                        raise RuntimeError(f"rank(s) {dead} exited with codes "
                                           f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if store is None:
            shutil.rmtree(_STORES.pop(), ignore_errors=True)
    return [out[r] for r in range(n)]


def kernel_launches():
    """Every kernel's launch count in this process."""
    from openmvg_torch.ops import seg_sum, smatvec, two_nn

    return {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in (two_nn, seg_sum, smatvec)}


def run_cli(rank, n, argv):
    """A spawn target: the CLI's main(argv) on this rank, with the kernels'
    launch counts set to 0 just before and read just after.  Returns
    dict(rc, stdout, launches)."""
    from openmvg_torch import cli
    from openmvg_torch.ops import seg_sum, smatvec, two_nn

    for m in (two_nn, seg_sum, smatvec):
        m.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return dict(rc=rc, stdout=buf.getvalue(), launches=kernel_launches())
