"""Process groups and the launch of ranks — counterpart of
``piecewise_icp_tpu/parallel/distributed.py``.

Every rank runs the same host program on its own shard of the points; the
staged loop's host control flow reads only values that every rank holds
bit for bit (reduced or replicated), so every rank takes the same branches
and meets the same collectives.

The backend is chosen explicitly and never changes on its own:

* ``nccl`` on ``cuda``, one card a rank (rank r on ``cuda:r``); it
  raises where fewer cards are visible than ranks;
* ``gloo`` on ``cpu``, or on ``cuda`` when the caller names it (rank r on
  ``cuda:{r % device_count}``: several ranks may share one card).

Ranks meet through a ``FileStore`` in a temporary directory (no TCP port,
so concurrent launches cannot clash) and give up after ``timeout``
seconds in a collective, so a rank left waiting fails instead of hanging.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from ..utils.logging import log
from .sharded import ShardGroup

# seconds a rank waits in one collective before the run fails (the
# backends' defaults are 10 and 30 minutes)
DEFAULT_TIMEOUT_S = 300.0


def _rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_backend(nproc: int, device: "str | torch.device",
                  backend: "str | None") -> str:
    """The backend of ``nproc`` ranks on ``device``: ``backend`` if given,
    else ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.  Raises where the
    combination cannot run as asked."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(f"{nproc} ranks on {device!r} requested but "
                               "no CUDA device is visible")
        if backend == "nccl" and count < nproc:
            raise RuntimeError(f"nccl runs one card a rank: {nproc} ranks "
                               f"requested, {count} CUDA device(s) visible")
    elif dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU take the gloo backend")
    else:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return backend


def initialize_worker(rank: int, world_size: int, init_file: str,
                      backend: str, device: "str | torch.device",
                      timeout: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """Join this process to a group of ``world_size`` ranks that meet at
    ``init_file`` (a path every rank can reach), and return its
    :class:`ShardGroup`.  ``device`` is ``"cuda"`` or ``"cpu"``: the
    rank's own device follows from the rule in the module docstring."""
    dev = _rank_device(rank, backend, torch.device(device).type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return ShardGroup(rank, world_size, dev, backend)


def _rank_main(rank: int, nproc: int, init_file: str, backend: str,
               device_type: str, timeout: float, out_path: str, fn, args,
               kw) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))
    if rank:
        log.setLevel(logging.WARNING)   # one narrative: rank 0's
    group = initialize_worker(rank, nproc, init_file, backend, device_type,
                              timeout)
    try:
        result = fn(group, *args, **kw)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _rank_errors(ctx) -> str:
    """The tracebacks that the ranks of ``ctx`` left, by rank."""
    out = []
    for rank, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                out.append(f"-- rank {rank}:\n{pickle.load(f)}")
    return "\n".join(out)


def launch(fn, nproc: int, *args, device: "str | torch.device" = "cuda",
           backend: "str | None" = None, timeout: "float | None" = None,
           **kw):
    """Run ``fn(group, *args, **kw)`` in ``nproc`` fresh processes (the
    spawn start method), one rank each, and return rank 0's result.

    ``fn`` must be importable by name (a module-level function).  As soon
    as any rank raises or dies, the others are terminated and this raises
    (``torch.multiprocessing.ProcessRaisedException`` with the rank's
    traceback).  ``timeout``: the seconds the whole launch may take (then
    every rank is killed and this raises ``TimeoutError``), which also
    bounds a rank's wait in one collective; None: no limit on the launch,
    :data:`DEFAULT_TIMEOUT_S` in a collective.  On ``cuda`` the kernel
    library is built here once, before the ranks start.
    """
    import torch.multiprocessing as mp

    backend = check_backend(nproc, device, backend)
    device_type = torch.device(device).type
    if device_type == "cuda":
        from ..ops import _cuda
        _cuda.build()
    wait_s = DEFAULT_TIMEOUT_S if timeout is None else timeout
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="pwicp_ranks_") as tmp:
        out_path = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_main, args=(nproc, os.path.join(tmp, "store"), backend,
                              device_type, wait_s, out_path, fn, args, kw),
            nprocs=nproc, join=False, start_method="spawn")
        try:
            while not ctx.join(
                    timeout=None if deadline is None
                    else max(deadline - time.monotonic(), 0.0),
                    grace_period=5.0):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{nproc} ranks still running after "
                                       f"{timeout:g} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # the first rank to end may be one that lost its peer; name
            # every rank's error, so the first cause is among them
            raise mp.ProcessRaisedException(
                f"{e}\n{_rank_errors(ctx)}", e.error_index,
                e.error_pid) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(out_path, "rb") as f:
            return pickle.load(f)


def run_on_rank(group: ShardGroup, fn, *args, **kw):
    """``fn(*args, device=<this rank's device>, group=group, **kw)``: one
    rank of a :func:`launch` of an entry point that takes ``device`` and
    ``group`` (``launch(run_on_rank, n, piecewise_icp_pair_call, ...)``)."""
    return fn(*args, device=group.device, group=group, **kw)


def gather_rows(x: torch.Tensor, group: "ShardGroup | None") -> torch.Tensor:
    """The whole of a point-sharded tensor on every rank (``x`` itself
    without a group) — counterpart of the reference's ``fetch``, used by
    the exact-percentile fallback and the final stable mask."""
    return x if group is None else group.gather(x)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1
