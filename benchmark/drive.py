"""The entries that a traffic mix drives, found by the mix's ``entry``.

Each entry is a closed loop with one client.  ``warm()`` runs the cell's
own shapes once, inside set-up; ``request(k)`` runs the k-th request of
the loop to its end on the card and returns what the judge reads, with
``units``, the work it completed in the unit of the cell's rate.  These
are the only places that call the program.
"""

from __future__ import annotations

import math
import os
import pathlib
import time
from typing import Dict, List

import numpy as np


# the fields of the reference's 11-line configuration file
FILE_FIELDS = ("path1", "path2", "set_res_svsize", "res1", "res2", "svsize1",
               "svsize2", "set_dtinit", "dt_init", "dt_min", "visual")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_config(settings: dict):
    from piecewise_icp_torch.config import PiecewiseICPConfig

    return PiecewiseICPConfig(**settings).validate()


class PairStream:
    """``register_pair(epoch_i, epoch_i+1)`` over the series in turn, with
    the arguments ``piecewise_icp_pair_call`` passes (the configuration,
    the device; the pair's SOR multiplier)."""

    def __init__(self, epochs: List[np.ndarray], gt, config: dict,
                 traffic: dict, workdir: pathlib.Path, dev, seconds: float):
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
        _sync(self.dev)
        return {"pair": i, "trans_mat": np.asarray(out.trans_mat),
                "vcm": np.asarray(out.vcm), "units": 1}


def write_pcd(path: pathlib.Path, points: np.ndarray) -> None:
    """Binary PCD v0.7 of float32 xyz (the layout of PCL's
    ``savePCDFileBinary``)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = len(pts)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              "DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())


def write_ground_truth(path: pathlib.Path, gt) -> None:
    """``defined_transformations.txt``: the 1-based epoch, then its 4x4."""
    lines = []
    for k, g in enumerate(gt):
        lines.append(str(k + 1))
        lines.extend(" ".join(f"{v:.12f}" for v in row) for row in g)
    path.write_text("\n".join(lines) + "\n")


class Campaign:
    """``piecewise_icp_4d_call`` over the whole series written as PCD
    files, one campaign at a time.  Every campaign reads its epochs from a
    folder of links that no earlier campaign of the process read, so the
    program's path-keyed cloud cache serves no repeat.  The folders and
    their configuration files are written in set-up, twice as many as the
    warm campaign's time says the window can start."""

    def __init__(self, epochs: List[np.ndarray], gt, config: dict,
                 traffic: dict, workdir: pathlib.Path, dev, seconds: float):
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
        _sync(self.dev)
        if not ok:
            raise RuntimeError(f"campaign {k}: piecewise_icp_4d_call "
                               "returned False")
        return {"campaign": k, "out": root / "out",
                "units": self.n_epochs - 1}


ENTRIES = {"pair": PairStream, "campaign": Campaign}
