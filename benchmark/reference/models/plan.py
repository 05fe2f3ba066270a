"""Adaptive registration-pair planning on clouds in memory: a copy of
``adaptive_pair_sequence`` of the port's ``models/four_d.py`` that takes
the epochs instead of their files and also returns every overlap probe it
made, (target, source, brute), brute where the target's extent admits no
dense grid and the probe took the brute 1-NN."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.grid_nn import CellGrid, build_grid
from ..ops.preprocess import overlap_ratio, overlap_ratio_grid


def adaptive_pair_sequence(epochs: Sequence[np.ndarray], start_epoch: int,
                           dt_init: float, ratio_thd: float,
                           device: "str | torch.device" = "cuda"
                           ) -> Tuple[Dict[int, int], Dict[int, float],
                                      List[Tuple[int, int, bool]]]:
    """For each source epoch j, advance the target from the last chosen
    one until the overlap ratio (fraction of C2C NN distances < DTinit)
    exceeds the threshold.  Returns {source: target} in indices relative
    to ``start_epoch``, the ratios and the probes."""
    dev = resolve_device(device)
    pairs: Dict[int, int] = {}
    ratios: Dict[int, float] = {}
    probes: List[Tuple[int, int, bool]] = []
    clouds: Dict[int, torch.Tensor] = {}
    grids: Dict[int, Optional[CellGrid]] = {}

    def cloud(i: int) -> torch.Tensor:
        if i not in clouds:
            pts = np.asarray(epochs[i], dtype=np.float32)
            clouds[i] = torch.from_numpy(pts).to(dev)
            try:
                grids[i] = CellGrid.from_index(build_grid(pts, h=dt_init),
                                               dev)
            except ValueError:
                grids[i] = None     # the dense grid is infeasible here
        return clouds[i]

    idx_target = start_epoch
    for j in range(start_epoch + 1, len(epochs)):
        for old in [k for k in list(clouds) if k < idx_target]:
            clouds.pop(old, None)
            grids.pop(old, None)
        src = cloud(j)
        ratio = 0.0
        for t in range(idx_target, j):
            tgt = cloud(t)
            brute = grids[t] is None
            if brute:
                ratio = overlap_ratio(tgt, src, dt_init)
            else:
                ratio = overlap_ratio_grid(grids[t], src, dt_init)
            probes.append((t, j, brute))
            idx_target = t
            if ratio > ratio_thd:
                break
        pairs[j - start_epoch] = idx_target - start_epoch
        ratios[j - start_epoch] = ratio
    return pairs, ratios, probes


class PlanSteps:
    """The adaptive scan one source at a time: :meth:`target` runs the scan
    of source ``j`` from a given first target, as
    :func:`adaptive_pair_sequence` does from the target its previous source
    chose, so a plan can be checked source by source.  Each epoch is loaded
    and gridded once."""

    def __init__(self, epochs: Sequence[np.ndarray], dt_init: float,
                 ratio_thd: float, device: "str | torch.device" = "cuda"):
        self.epochs = epochs
        self.dt_init = dt_init
        self.ratio_thd = ratio_thd
        self.dev = resolve_device(device)
        self.clouds: Dict[int, torch.Tensor] = {}
        self.grids: Dict[int, Optional[CellGrid]] = {}

    def cloud(self, i: int) -> torch.Tensor:
        if i not in self.clouds:
            pts = np.asarray(self.epochs[i], dtype=np.float32)
            self.clouds[i] = torch.from_numpy(pts).to(self.dev)
            try:
                self.grids[i] = CellGrid.from_index(
                    build_grid(pts, h=self.dt_init), self.dev)
            except ValueError:
                self.grids[i] = None
        return self.clouds[i]

    def target(self, j: int, first: int
               ) -> Tuple[int, float, List[Tuple[int, int, bool]]]:
        """(target, ratio, probes) of source ``j`` scanning from ``first``."""
        src = self.cloud(j)
        ratio, idx_target, probes = 0.0, first, []
        for t in range(first, j):
            tgt = self.cloud(t)
            brute = self.grids[t] is None
            if brute:
                ratio = overlap_ratio(tgt, src, self.dt_init)
            else:
                ratio = overlap_ratio_grid(self.grids[t], src, self.dt_init)
            probes.append((t, j, brute))
            idx_target = t
            if ratio > self.ratio_thd:
                break
        return idx_target, ratio, probes
