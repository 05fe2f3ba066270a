"""Point-sharded Piecewise-ICP over a ``torch.distributed`` process group —
counterpart of ``piecewise_icp_tpu/parallel/sharded.py``.

The clouds are split along the point axis across the ranks of a process
group; the patch arrays (centroids, boundary points, STDs: about 10^3
rows) and the target grid are replicated, since every rank needs them to
classify.  The collectives of one iteration, each at the place of the
reference's:

* the inner ICP's normal equations: each rank accumulates A^T A, A^T L,
  the MSE sum and the row count over its contiguous slice of the source
  centroids, and ONE packed all-reduce merges them before the 6x6 solve,
  which every rank then runs on the same bits (``models/icp.py``);
* the min and max of the moving cloud's bounding box;
* the stage-1 percentile: K1 and the K5 rescue on this rank's queries,
  then ONE gather of the distances and ONE packed sum of the counts;
* the sum of the stable points.

There is one iteration body, ``models.piecewise_icp._iteration_step``:
its ``group`` argument takes the place of the reference's
``build_sharded_iteration`` (``shard_map`` around the same body), and
``group=None`` is the single-device path.

A float sum across ranks adds in another order than on one device, so a
sharded result is held to the single-device one at a tolerance; it is the
same on every rank (every rank solves on the same reduced bits) and from
run to run.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.errors import PwICPError
from ..utils.logging import note_sync, to_host


class ShardGroup:
    """A process group as the staged loop uses it: this rank, the number of
    ranks, the device of this rank's tensors, and the collectives.

    Every collective counts its calls and the bytes of its result on this
    rank in :attr:`calls` and :attr:`bytes` (by name), so that a run can
    show what crossed the ranks.  Under ``gloo`` the collectives take CUDA
    tensors as they are: the backend stages them through host memory
    itself.
    """

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, pg=None) -> None:
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.pg = pg
        self.calls: "collections.Counter[str]" = collections.Counter()
        self.bytes: "collections.Counter[str]" = collections.Counter()

    def __repr__(self) -> str:
        return (f"ShardGroup(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def local_device(self, device: "str | torch.device") -> torch.device:
        """``device`` resolved as every entry point resolves it; raises
        unless it is this rank's device."""
        dev = resolve_device(device)
        if dev != self.device:
            raise ValueError(f"device {dev} is not this rank's "
                             f"({self.device})")
        return dev

    def _count(self, name: str, t: torch.Tensor) -> None:
        self.calls[name] += 1
        self.bytes[name] += t.numel() * t.element_size()

    def _reduce(self, x: torch.Tensor, op, name: str) -> torch.Tensor:
        out = x.detach().clone()
        dist.all_reduce(out, op=op, group=self.pg)
        self._count(name, out)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM, "sum")

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN, "min")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX, "max")

    def sum_many(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Sum several tensors of one dtype over the ranks in ONE
        all-reduce: flattened, concatenated, reduced, split back."""
        flat = torch.cat([x.reshape(-1) for x in xs])
        red = self._reduce(flat, dist.ReduceOp.SUM, "sum_many")
        out, o = [], 0
        for x in xs:
            out.append(red[o:o + x.numel()].reshape(x.shape))
            o += x.numel()
        return tuple(out)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on each) concatenated along the
        first axis in rank order, on every rank: the whole of a
        point-sharded tensor.  A bool tensor travels as bytes."""
        src = x.contiguous()
        if src.dtype == torch.bool:
            return self.gather(src.view(torch.uint8)).view(torch.bool)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        out = torch.cat(parts)
        self._count("gather", out)
        return out

    def gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (for reports)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.pg, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.pg)
        self.calls["barrier"] += 1

    def pad_rows(self, x: torch.Tensor, value=0) -> torch.Tensor:
        """``x`` with rows of ``value`` appended up to a multiple of the
        number of ranks."""
        n = x.shape[0]
        extra = -n % self.size
        if not extra:
            return x
        return torch.cat([x, torch.full((extra, *x.shape[1:]), value,
                                        dtype=x.dtype, device=x.device)])

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of rows of a padded ``x`` (a view)."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks: "
                             "pad them first (pad_rows)")
        rows = n // self.size
        return x[self.rank * rows:(self.rank + 1) * rows]

    def check_replicated(self, *tensors: torch.Tensor) -> None:
        """Raise :class:`PwICPError` on every rank unless each tensor has
        the same bits on every rank.

        A checksum of each tensor's bytes (each byte times its position mod
        65521, plus one, summed in int64: a changed bit changes it) is
        reduced by MAX as ``[c, -c]``, which gives the largest and the
        smallest checksum over the ranks in one all-reduce."""
        sums = []
        for t in tensors:
            b = t.detach().contiguous().reshape(-1).view(torch.uint8)
            w = torch.arange(b.numel(), device=b.device) % 65521 + 1
            sums.append((b.to(torch.int64) * w).sum())
        c = torch.stack(sums)
        red = self._reduce(torch.cat([c, -c]), dist.ReduceOp.MAX,
                           "check_replicated")
        hi, lo = red[:len(sums)], -red[len(sums):]
        bad = torch.nonzero(hi != lo).reshape(-1)
        note_sync(bad)
        differ = to_host(bad).tolist()
        if differ:
            raise PwICPError(f"replicated inputs {differ} (of "
                             f"{len(sums)}) differ between the ranks")


def make_group(device: "torch.device | None" = None) -> ShardGroup:
    """The :class:`ShardGroup` of the default process group, which this
    process has joined (``parallel.distributed.initialize_worker``) —
    counterpart of the reference's ``make_mesh``.  ``device`` defaults to
    this rank's current CUDA device under NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize_worker first")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return ShardGroup(dist.get_rank(), dist.get_world_size(),
                      torch.device(device), backend)
