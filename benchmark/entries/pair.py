"""The pair stream: ``register_pair(epoch i, epoch i+1)`` over the series in
turn, one client; judged on a sample of the series' pairs."""

from __future__ import annotations

import pathlib
from typing import Dict, List

import numpy as np

from .. import judge
from ..drive import program_config, sync


class PairStream:
    """``register_pair(epoch_i, epoch_i+1)`` over the series in turn, with
    the arguments ``piecewise_icp_pair_call`` passes (the configuration,
    the device; the pair's SOR multiplier).  One card: the other
    ``devices`` and ``children`` go unused."""

    def __init__(self, epochs: List[np.ndarray], gt, config: dict,
                 traffic: dict, workdir: pathlib.Path, dev, seconds: float,
                 devices=None, children=None):
        from piecewise_icp_torch.models.pairwise import register_pair

        self.register_pair = register_pair
        self.epochs = epochs
        self.cfg = program_config(config["settings"])
        self.dev = dev
        self.n_pairs = len(epochs) - 1

    def pair_of(self, k: int) -> int:
        return k % self.n_pairs

    def warm(self) -> None:
        self.request(0)

    def request(self, k: int) -> Dict:
        i = self.pair_of(k)
        out = self.register_pair(self.epochs[i], self.epochs[i + 1],
                                 self.cfg, device=self.dev)
        sync(self.dev)
        return {"pair": i, "trans_mat": np.asarray(out.trans_mat),
                "vcm": np.asarray(out.vcm), "units": 1}


def judge_pair_cell(answers, epochs, gt, cell, seed: int, dev) -> Dict:
    return judge.judge_pairs(answers, epochs, cell.config["settings"],
                             cell.traffic, seed, dev)


def control_pair_cell(cell, epochs, gt, seed: int, dev) -> dict:
    """The numbers of a run in which every request of the window was
    answered by the reference with TF32 on."""
    settings = cell.config["settings"]
    # a window of this length completes every pair of the series
    chosen = judge.sample_pairs(list(range(len(epochs) - 1)),
                                int(cell.traffic["checked_pairs"]), seed)
    low = []
    for i in chosen:
        with judge.matmul_tf32(True):
            out = judge.reference_pair(epochs, i, settings, dev)
        low.append(dict(out, pair=i))
    return judge.judge_pairs(low, epochs, settings, cell.traffic, seed, dev)


ENTRY = PairStream
JUDGE = judge_pair_cell
CHECKS = ("pose_gap_mm", "sigma_gap")
CONTROL = control_pair_cell
