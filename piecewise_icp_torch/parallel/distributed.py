"""Process groups and the launch of ranks — counterpart of
``piecewise_icp_tpu/parallel/distributed.py``.

Every rank runs the same host program on its own shard of the points; the
staged loop's host control flow reads only values that every rank holds
bit for bit (reduced or replicated), so every rank takes the same branches
and meets the same collectives.

A job spans one host or several.  On each host one launcher
(:func:`launch`) spawns that host's ``nproc`` ranks: host ``h``'s local
rank ``i`` is global rank ``h * nproc + i``, and its local index ``i``
chooses its card.  The backend is chosen explicitly and never changes on
its own:

* ``nccl`` on ``cuda``, one card a rank (local rank i on ``cuda:i``); it
  raises where a host sees fewer cards than it runs ranks;
* ``gloo`` on ``cpu``, or on ``cuda`` when the caller names it (local rank
  i on ``cuda:{i % device_count}``: several ranks may share one card).

The ranks of one host meet through a ``FileStore`` in a temporary
directory (no TCP port, so concurrent launches cannot clash); those of
several hosts at a rendezvous address, ``tcp://host:port`` (global rank
0's host; its rank 0 serves the store there) or a file on a file system
that every host shares.  A rank gives up after ``timeout`` seconds in a
collective, so a rank left waiting fails instead of hanging.
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


def _rank_device(local_rank: int, backend: str,
                 device_type: str) -> torch.device:
    """The device of the rank with index ``local_rank`` on its host."""
    if device_type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if backend == "nccl":
        if local_rank >= count:
            raise RuntimeError(f"nccl runs one card a rank: local rank "
                               f"{local_rank} finds {count} CUDA device(s)")
        return torch.device("cuda", local_rank)
    if count == 0:
        raise RuntimeError("a rank on cuda finds no CUDA device")
    return torch.device("cuda", local_rank % count)


def check_backend(nproc: int, device: "str | torch.device",
                  backend: "str | None") -> str:
    """The backend of ``nproc`` ranks on this host's ``device``:
    ``backend`` if given, else ``nccl`` on ``cuda`` and ``gloo`` on
    ``cpu``.  Raises where the combination cannot run as asked (under
    nccl, where this host sees fewer cards than ``nproc``)."""
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
                               f"on this host requested, {count} CUDA "
                               "device(s) visible")
    elif dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU take the gloo backend")
    else:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return backend


def _init_method(address: str) -> str:
    """``tcp://host:port`` and ``file://path`` as they are; a bare path
    as a ``file://`` store."""
    if address.startswith(("tcp://", "file://")):
        return address
    return "file://" + os.path.abspath(address)


def initialize_worker(rank: int, world_size: int, address: str,
                      backend: str, device: "str | torch.device",
                      timeout: float = DEFAULT_TIMEOUT_S,
                      local_rank: "int | None" = None) -> ShardGroup:
    """Join this process to a job of ``world_size`` ranks that meet at
    ``address`` (``tcp://host:port``, whose host runs global rank 0, or a
    file every rank can reach), and return its :class:`ShardGroup` —
    counterpart of the reference's ``initialize_worker(coordinator_address,
    num_processes, process_id)``.  ``local_rank``, this rank's index on
    its host (``rank`` on a job of one host), chooses its card on
    ``cuda`` by the rule in the module docstring."""
    local = rank if local_rank is None else local_rank
    dev = _rank_device(local, backend, torch.device(device).type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(address), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    return ShardGroup(rank, world_size, dev, backend)


def _rank_main(local_rank: int, nproc: int, host: int, hosts: int,
               address: str, backend: str, device_type: str, timeout: float,
               call_path: str, out_path: str) -> None:
    with open(call_path, "rb") as f:
        fn, args, kw = pickle.load(f)
    rank = host * nproc + local_rank
    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))
    if rank:
        log.setLevel(logging.WARNING)   # one narrative: rank 0's
    group = initialize_worker(rank, hosts * nproc, address, backend,
                              device_type, timeout, local_rank=local_rank)
    try:
        result = fn(group, *args, **kw)
        if local_rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _rank_errors(ctx, first_rank: int) -> str:
    """The tracebacks that the ranks of ``ctx`` left, by global rank."""
    out = []
    for i, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                out.append(f"-- rank {first_rank + i}:\n{pickle.load(f)}")
    return "\n".join(out)


def launch(fn, nproc: int, *args, device: "str | torch.device" = "cuda",
           backend: "str | None" = None, timeout: "float | None" = None,
           host: int = 0, hosts: int = 1, address: "str | None" = None,
           **kw):
    """Run ``fn(group, *args, **kw)`` in ``nproc`` fresh processes (the
    spawn start method), one rank each, and return local rank 0's result.

    On one host (``hosts=1``) the ranks are the whole job and meet through
    a file store in a temporary directory.  On several, one launcher runs on each host with its index ``host`` of
    ``hosts`` and the same ``address`` (see :func:`initialize_worker`):
    its ranks are global ranks ``host * nproc`` to ``host * nproc + nproc
    - 1`` of ``hosts * nproc``.  A result that ``fn`` gathers from every
    rank (``group.gather_object``) is the same in every launcher.

    ``fn`` must be importable by name (a module-level function).  As soon
    as any rank of this host raises or dies, its others are terminated and
    this raises (``torch.multiprocessing.ProcessRaisedException`` with the
    rank's traceback); the ranks of other hosts then fail in their next
    collective.  ``timeout``: the seconds the whole launch may take (then
    every rank is killed and this raises ``TimeoutError``), which also
    bounds a rank's wait in one collective; None: no limit on the launch,
    :data:`DEFAULT_TIMEOUT_S` in a collective.  On ``cuda`` the kernel
    library is built here once, before the ranks start.
    """
    import torch.multiprocessing as mp

    if not 0 <= host < hosts:
        raise ValueError(f"host {host} of {hosts}")
    if (hosts > 1) != (address is not None):
        raise ValueError("the ranks of several hosts, and only they, meet "
                         "at an address (tcp://host:port or a shared file)")
    backend = check_backend(nproc, device, backend)
    device_type = torch.device(device).type
    if device_type == "cuda":
        from ..ops import _cuda
        _cuda.build()
    wait_s = DEFAULT_TIMEOUT_S if timeout is None else timeout
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="pwicp_ranks_") as tmp:
        # the call goes through a file: pickled into the spawn pipe, a
        # large argument blocks the start of each rank until the one
        # before has imported torch and read it, so ranks would start one
        # after another
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args, kw), f)
        out_path = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_main, args=(nproc, host, hosts,
                              address or os.path.join(tmp, "store"), backend,
                              device_type, wait_s, call_path, out_path),
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
                f"{e}\n{_rank_errors(ctx, host * nproc)}", e.error_index,
                e.error_pid) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(out_path, "rb") as f:
            return pickle.load(f)


def context_devices() -> list:
    """The CUDA devices (this process's ordinals) on which this process
    holds an active primary context, read from the driver without opening
    one: where every rank keeps to its own card, a rank's list is that
    card alone.  Empty where no CUDA device is visible."""
    if not torch.cuda.is_available():
        return []
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    if cu.cuInit(0):
        raise RuntimeError("the CUDA driver did not initialise")
    out = []
    for i in range(torch.cuda.device_count()):
        dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        err = cu.cuDeviceGet(ctypes.byref(dev), i) or \
            cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                          ctypes.byref(active))
        if err:
            raise RuntimeError(f"CUDA driver error {err} reading device {i}")
        if active.value:
            out.append(i)
    return out


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
