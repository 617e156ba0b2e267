"""Process groups and rank processes (the JAX package's ``parallel/mesh.py``).

The JAX package drives every device from one process through a mesh; the
port runs one process per rank, each on its own device, joined by a
``torch.distributed`` process group: NCCL between CUDA devices, gloo between
CPU ranks. `init_group` forms the group of ranks started on one host
(`spawn` starts them), `initialize_multihost` that of processes started
on several hosts. Nothing falls back from one backend to another: a group
that does not form raises.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a collective (and the rendezvous) may wait for the other ranks
# before it raises
DEFAULT_TIMEOUT_S = 1800.0


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank):
    """The device of rank ``rank``: ``cuda:<rank>`` for a CUDA run (each
    rank its own card), the CPU for a CPU run."""
    dev = torch.device(device)
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def _init(init_method, rank, world, device, backend, timeout_s):
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            # NCCL forms its communicator here, not at the first
            # collective, so that a failure raises at once
            kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def init_group(rank, world, device, port, *, backend=None,
               timeout_s=DEFAULT_TIMEOUT_S):
    """Join rank ``rank`` of ``world`` ranks on this host to the default
    process group, rendezvousing at ``tcp://127.0.0.1:<port>`` (`free_port`,
    chosen by the process that starts the ranks). ``backend`` None is NCCL
    for a CUDA ``device`` (made the current device) and gloo for the CPU;
    ``timeout_s`` bounds the rendezvous and every collective."""
    _init(f"tcp://127.0.0.1:{int(port)}", rank, world, device, backend,
          timeout_s)


def initialize_multihost(coordinator=None, num_processes=None,
                         process_id=None, device="cpu", *,
                         timeout_s=DEFAULT_TIMEOUT_S):
    """Multi-host rendezvous (``parallel/mesh.py:18-28`` of the JAX
    package; the reference's ``dist.init_process_group``): process
    ``process_id`` of ``num_processes`` joins the default process group at
    ``coordinator`` (``host:port``) on ``device``, with `init_group`'s
    backend and timeout. A no-op for a single-process run."""
    if num_processes is None or num_processes <= 1:
        return
    _init(f"tcp://{coordinator}", int(process_id), int(num_processes),
          device, None, timeout_s)


def world_size() -> int:
    """The ranks of the default process group; 1 when none is formed."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 when no process group is formed."""
    return dist.get_rank() if dist.is_initialized() else 0


def resolve_world(count, device) -> int:
    """The rank count of a ``count`` key (``n_devices``,
    ``sharded_devices``) on ``device`` (``train.py:403-404``, ``test.py:
    100``): on a CUDA device 0 means every visible card and a larger count
    is clamped to them; on the CPU it is that many ranks, 0 one."""
    count = int(count)
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        return min(count or visible, visible)
    return max(count, 1)


def all_reduce_sum(t):
    """Sum ``t`` over the ranks in place and return it; ``t`` itself
    without a process group. A group of one rank still runs the
    collective."""
    if dist.is_initialized():
        dist.all_reduce(t)
    return t


def all_gather_rows(t):
    """``[world, *t.shape]``: row ``r`` is rank ``r``'s ``t``. Each rank
    fills its own row of a zero-filled buffer and the buffers are summed
    (`all_reduce_sum`), which is exact (``x + 0 == x``) and runs on CUDA
    tensors under NCCL and gloo alike (gloo's ``all_gather`` takes none)."""
    out = t.new_zeros((world_size(),) + tuple(t.shape))
    out[rank()] = t
    return all_reduce_sum(out)


def barrier():
    """Wait for every rank; nothing without a process group."""
    if world_size() > 1:
        dist.barrier()


def spawn(fn, world, args=(), timeout_s=None):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the ``spawn``
    start method) and wait for all of them. A rank that raises or dies
    ends the others and raises here; past ``timeout_s`` seconds (None: no
    limit) every rank still running is killed and TimeoutError raised."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
