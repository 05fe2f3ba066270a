"""The campaign: ``piecewise_icp_4d_call`` over the whole series written
as PCD files, one campaign at a time, one client; judged on its plan, a
sample of its pairs and its chained and smoothed series."""

from __future__ import annotations

import math
import os
import pathlib
import time
from typing import Dict, List

import numpy as np

from .. import judge
from ..drive import (FILE_FIELDS, program_config, sync, write_ground_truth,
                     write_pcd)


class Campaign:
    """``piecewise_icp_4d_call`` over the whole series written as PCD
    files, one campaign at a time.  Every campaign reads its epochs from a
    folder of links that no earlier campaign of the process read, so the
    program's path-keyed cloud cache serves no repeat.  The folders and
    their configuration files are written in set-up, twice as many as the
    warm campaign's time says the window can start.  One card: the other
    ``devices`` and ``children`` go unused."""

    def __init__(self, epochs: List[np.ndarray], gt, config: dict,
                 traffic: dict, workdir: pathlib.Path, dev, seconds: float,
                 devices=None, children=None):
        from piecewise_icp_torch.models.four_d import piecewise_icp_4d_call

        self.call = piecewise_icp_4d_call
        self.epochs = epochs
        self.settings = dict(config["settings"])
        self.campaign = config["campaign"]
        self.dev = dev
        self.workdir = workdir
        self.n_epochs = len(epochs)
        data = workdir / "data"
        data.mkdir(parents=True, exist_ok=True)
        self.files = []
        for k, e in enumerate(epochs):
            name = f"Epoch_{k + 1:03d}.pcd"
            write_pcd(data / name, e)
            self.files.append(data / name)
        self.gt_file = None
        if gt is not None:
            self.gt_file = data / "defined_transformations.txt"
            write_ground_truth(self.gt_file, gt)
        self.prepared = 0
        self.seconds = seconds

    def folder(self, k: int) -> pathlib.Path:
        return self.workdir / f"campaign_{k:05d}"

    def prepare(self, count: int) -> None:
        """Folders of links and configuration files for campaigns up to
        ``count``."""
        while self.prepared < count:
            root = self.folder(self.prepared)
            scans = root / "scans"
            scans.mkdir(parents=True)
            for f in self.files:
                os.symlink(f, scans / f.name)
            if self.gt_file is not None:
                os.symlink(self.gt_file, root / self.gt_file.name)
            program_config(dict(self.settings, path1=str(root / "scans"),
                                path2=str(root / "out") + os.sep)
                           ).to_reference_file(root / "config.txt")
            self.prepared += 1

    def warm(self) -> None:
        t0 = time.perf_counter()
        self.request(0)
        self.prepare(1 + math.ceil(2 * self.seconds
                                   / (time.perf_counter() - t0)) + 1)

    def request(self, k: int) -> Dict:
        self.prepare(k + 1)
        root = self.folder(k)
        # what the 11-line file cannot carry goes as keyword overrides,
        # as a caller of the file entry passes it
        extra = {key: v for key, v in self.settings.items()
                 if key not in FILE_FIELDS}
        ok = self.call(str(root / "config.txt"), 0, self.n_epochs,
                       int(self.campaign["pair_mode"]),
                       float(self.campaign["overlap_threshold"]),
                       device=self.dev, **extra)
        sync(self.dev)
        if not ok:
            raise RuntimeError(f"campaign {k}: piecewise_icp_4d_call "
                               "returned False")
        return {"campaign": k, "out": root / "out",
                "units": self.n_epochs - 1}


def judge_campaign_cell(answers, epochs, gt, cell, seed: int, dev) -> Dict:
    read = [judge.campaign_answer(a["out"], len(epochs)) for a in answers]
    return judge.judge_series(read, epochs, cell.config["settings"],
                              cell.config["campaign"], cell.traffic, seed,
                              dev)


def control_campaign_cell(cell, epochs, gt, seed: int, dev) -> dict:
    """A campaign answered by the reference with TF32 on: its plan, its
    sampled pairs, and the chained and smoothed series of its pairs.  The
    pairs the judge does not sample enter both sides' series alike, so
    they stand as the ground truth's pair transforms with the sampled
    pairs' mean VCM instead of being registered."""
    from ..reference.models.plan import adaptive_pair_sequence

    settings, campaign = cell.config["settings"], cell.config["campaign"]
    cfg = judge.reference_config(settings)
    plan, _, _ = adaptive_pair_sequence(
        epochs, 0, cfg.dt_init, float(campaign["overlap_threshold"]), dev)
    sources = judge.plan_sources(len(epochs), cell.traffic, seed)
    steps = sources[:int(cell.traffic["checked_pairs"])]
    low = {}
    for s in steps:
        with judge.matmul_tf32(True):
            low[s] = judge.reference_campaign_pair(epochs, plan[s], s,
                                                   settings, dev)
    mean_vcm = np.mean([low[s]["vcm"] for s in steps], axis=0)
    pairs = []
    for s in range(1, len(epochs)):
        if s in low:
            pairs.append((low[s]["trans_mat"], low[s]["vcm"]))
        else:
            pairs.append((np.linalg.inv(gt[plan[s]]) @ gt[s], mean_vcm))
    series = judge.reference_series([t for t, _ in pairs],
                                    [v for _, v in pairs], plan, settings)
    answer = dict(series, plan=plan, pairs=pairs)
    out = judge.judge_series([answer], epochs, settings, campaign,
                             cell.traffic, seed, dev)
    out.pop("plan_probes")
    return out


ENTRY = Campaign
JUDGE = judge_campaign_cell
CHECKS = ("plan_mismatch", "pose_gap_mm", "sigma_gap")
CONTROL = control_campaign_cell
