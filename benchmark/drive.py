"""What the request kinds (``benchmark/entries/``) share: the fields of
the reference's configuration file, the program's configuration, the
series written as PCD files, and the wait for the card.
"""

from __future__ import annotations

import pathlib

import numpy as np


# the fields of the reference's 11-line configuration file
FILE_FIELDS = ("path1", "path2", "set_res_svsize", "res1", "res2", "svsize1",
               "svsize2", "set_dtinit", "dt_init", "dt_min", "visual")


def sync(dev) -> None:
    """Wait for the card's work (nothing on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_config(settings: dict):
    from piecewise_icp_torch.config import PiecewiseICPConfig

    return PiecewiseICPConfig(**settings).validate()


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
