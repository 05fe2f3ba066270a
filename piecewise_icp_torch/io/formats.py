"""Readers / writers for the reference's result-file formats.

These match the reference byte layouts so outputs can be diffed directly
against the shipped goldens in ``python/results/``:

* ``TransMatrix.txt``            — pairwise report (Registration.cpp:340-387)
* ``TransMatrices.txt``          — per-pair 4x4 + 6x6 VCM blocks per epoch
                                   (Registration.cpp:152-167)
* ``TransParameters.txt``        — per-epoch parameter rows in gon/mgon/mm
                                   (Registration.cpp:78-80, :169-180)
* ``TransMatrices_toRef.txt`` / ``TransParameters_toRef.txt``
                                   (Registration.cpp:1112-1149)
* ``TransPara_AbsError.txt``     — accuracy vs ground truth
                                   (Registration.cpp:1207-1249)
* ``RegPairFile.txt``            — adaptive pair plan (Registration.cpp:578-586)
* ``defined_transformations.txt``— ground-truth 4x4 per epoch (data_synthetic)

The port's own copy of ``piecewise_icp_tpu/io/formats.py``.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import ARC_TO_GON
from ..utils.errors import FileFormatError


def _fmt_mat(mat: np.ndarray, prec: int = 12) -> str:
    rows = []
    for row in np.asarray(mat):
        rows.append(" ".join(f"{v:.{prec}f}" for v in row) + " ")
    return "\n".join(rows) + "\n"


# ----------------------------------------------------------------------
# Pairwise report: TransMatrix.txt (Registration.cpp:340-387)
# ----------------------------------------------------------------------

def write_trans_matrix_report(path: str | pathlib.Path,
                              trans_mat: np.ndarray,
                              angles_rad: np.ndarray,
                              translation: np.ndarray,
                              vcm: np.ndarray) -> None:
    vcm = np.asarray(vcm, dtype=np.float64)
    std = np.sqrt(np.clip(np.diag(vcm), 0.0, None))
    txt = []
    txt.append("4x4 Transformation Matrix:\n")
    txt.append(_fmt_mat(trans_mat, 12))
    txt.append("\n")
    txt.append("Rotation Angles (unit: gon):\n")
    for name, a in zip("xyz", np.asarray(angles_rad, dtype=np.float64)):
        txt.append(f"R{name} = {a * ARC_TO_GON:.10f}\n")
    txt.append("Translation (unit: m):\n")
    for name, t in zip("xyz", np.asarray(translation, dtype=np.float64)):
        txt.append(f"t{name} = {t:.10f}\n")
    txt.append("\n")
    txt.append("6x6 Variance-Covariance Matrix of transformation parameters:\n")
    txt.append(_fmt_mat(vcm, 12))
    txt.append("\n")
    txt.append("Standard Deviations of estimated transformation parameters:\n")
    txt.append(f"Std_Rx = {1000 * ARC_TO_GON * std[0]:.10f} mgon\n")
    txt.append(f"Std_Ry = {1000 * ARC_TO_GON * std[1]:.10f} mgon\n")
    txt.append(f"Std_Rz = {1000 * ARC_TO_GON * std[2]:.10f} mgon\n")
    txt.append(f"Std_tx = {1000 * std[3]:.10f} mm\n")
    txt.append(f"Std_ty = {1000 * std[4]:.10f} mm\n")
    txt.append(f"Std_tz = {1000 * std[5]:.10f} mm\n")
    pathlib.Path(path).write_text("".join(txt))


def read_trans_matrix_report(path: str | pathlib.Path) -> Dict[str, np.ndarray]:
    """Parse a TransMatrix.txt report back into arrays (for golden diffs)."""
    lines = pathlib.Path(path).read_text().splitlines()
    out: Dict[str, np.ndarray] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("4x4 Transformation Matrix"):
            out["trans_mat"] = np.array(
                [[float(v) for v in lines[i + 1 + r].split()] for r in range(4)])
            i += 5
        elif line.startswith("6x6 Variance-Covariance"):
            out["vcm"] = np.array(
                [[float(v) for v in lines[i + 1 + r].split()] for r in range(6)])
            i += 7
        elif "=" in line and line.split()[0] in (
                "Rx", "Ry", "Rz", "tx", "ty", "tz"):
            key = line.split()[0]
            out.setdefault("params", {})  # type: ignore[arg-type]
            out["params"][key] = float(line.split("=")[1].split()[0])  # type: ignore[index]
            i += 1
        elif line.startswith("Std_"):
            key = line.split()[0]
            out.setdefault("stds", {})  # type: ignore[arg-type]
            out["stds"][key] = float(line.split("=")[1].split()[0])  # type: ignore[index]
            i += 1
        else:
            i += 1
    if "trans_mat" not in out:
        raise FileFormatError(f"no transformation matrix in {path}")
    return out


# ----------------------------------------------------------------------
# 4D per-pair stream: TransMatrices.txt (Registration.cpp:152-167)
# ----------------------------------------------------------------------

def write_trans_matrices(path: str | pathlib.Path,
                         timestamps: Sequence[int],
                         trans_mats: Sequence[np.ndarray],
                         vcms: Sequence[np.ndarray]) -> None:
    with open(path, "w") as f:
        for ts, tm, vcm in zip(timestamps, trans_mats, vcms):
            f.write(f"{ts}\n")
            f.write(_fmt_mat(tm, 12))
            f.write(_fmt_mat(vcm, 12))


def read_trans_matrices(path: str | pathlib.Path, epoch_num: int
                        ) -> Tuple[List[int], List[np.ndarray], List[np.ndarray]]:
    """Whitespace-token reader matching calTransToReferenceEpoch's
    ``>>``-based parse (Registration.cpp:983-1011)."""
    tokens = pathlib.Path(path).read_text().split()
    ts_list, tm_list, vcm_list = [], [], []
    pos = 0
    for _ in range(epoch_num):
        if pos + 1 + 16 + 36 > len(tokens):
            raise FileFormatError(f"truncated TransMatrices file: {path}")
        ts_list.append(int(float(tokens[pos]))); pos += 1
        tm = np.array(tokens[pos:pos + 16], dtype=np.float64).reshape(4, 4)
        pos += 16
        vcm = np.array(tokens[pos:pos + 36], dtype=np.float64).reshape(6, 6)
        pos += 36
        tm_list.append(tm)
        vcm_list.append(vcm)
    return ts_list, tm_list, vcm_list


# ----------------------------------------------------------------------
# Parameter tables: TransParameters.txt (Registration.cpp:78-80, :169-180)
# ----------------------------------------------------------------------

TRANS_PARA_HEADER = ("Epoch  Rx[gon]  Ry[gon]  Rz[gon]  tx[m]  ty[m]  tz[m]  "
                     "Std_Rx[mgon]  Std_Ry[mgon]  Std_Rz[mgon]  "
                     "Std_tx[mm]  Std_ty[mm]  Std_tz[mm]")


def format_trans_para_row(timestamp: int, params_gon_m: np.ndarray,
                          vcm: np.ndarray) -> str:
    """One TransParameters row: params in gon/m, stds in mgon/mm."""
    p = np.asarray(params_gon_m, dtype=np.float64)
    std = np.sqrt(np.clip(np.diag(np.asarray(vcm, dtype=np.float64)), 0, None))
    vals = [f"{v:.10f}" for v in p]
    vals += [f"{1000 * std[i] * ARC_TO_GON:.10f}" for i in range(3)]
    vals += [f"{1000 * std[i]:.10f}" for i in range(3, 6)]
    return f"{timestamp} " + " ".join(vals)


def read_trans_parameters(path: str | pathlib.Path) -> np.ndarray:
    """Read a TransParameters table as a float array [N, 13]."""
    lines = pathlib.Path(path).read_text().splitlines()
    rows = [[float(v) for v in ln.split()] for ln in lines[1:] if ln.strip()]
    return np.array(rows, dtype=np.float64)


# ----------------------------------------------------------------------
# Adaptive pair plan: RegPairFile.txt (Registration.cpp:578-586)
# ----------------------------------------------------------------------

def write_reg_pairs(path: str | pathlib.Path, pairs: Dict[int, int]) -> None:
    with open(path, "w") as f:
        for src in sorted(pairs):
            f.write(f"{src} {pairs[src]}\n")


def read_reg_pairs(path: str | pathlib.Path) -> Dict[int, int]:
    pairs: Dict[int, int] = {}
    for ln in pathlib.Path(path).read_text().splitlines():
        parts = ln.split()
        if len(parts) >= 2:
            pairs[int(parts[0])] = int(parts[1])
    return pairs


# ----------------------------------------------------------------------
# Ground truth: defined_transformations.txt
# ----------------------------------------------------------------------

def read_ground_truth_transforms(path: str | pathlib.Path
                                 ) -> Tuple[List[int], List[np.ndarray]]:
    """Read ``<epoch>\\n<4x4>`` blocks (calAbsErrorOfTransPara's GT parse,
    Registration.cpp:1193-1204)."""
    tokens = pathlib.Path(path).read_text().split()
    ts_list, tm_list = [], []
    pos = 0
    while pos + 17 <= len(tokens):
        ts_list.append(int(float(tokens[pos]))); pos += 1
        tm_list.append(np.array(tokens[pos:pos + 16],
                                dtype=np.float64).reshape(4, 4))
        pos += 16
    return ts_list, tm_list


# ----------------------------------------------------------------------
# Accuracy analysis output (Registration.cpp:1213, :1247-1248)
# ----------------------------------------------------------------------

ABS_ERROR_HEADER = ("Err_Rx[mgon]  Err_Ry[mgon]  Err_Rz[mgon]  "
                    "Err_tx[mm]  Err_ty[mm]  Err_tz[mm]")


def write_abs_errors(path: str | pathlib.Path, errors: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(ABS_ERROR_HEADER + "\n")
        for row in np.asarray(errors):
            f.write(" ".join(f"{v:g}" for v in row) + " \n")


def read_abs_errors(path: str | pathlib.Path) -> np.ndarray:
    lines = pathlib.Path(path).read_text().splitlines()
    rows = [[float(v) for v in ln.split()] for ln in lines[1:] if ln.strip()]
    return np.array(rows, dtype=np.float64)
