"""Transform chaining to the reference epoch with covariance propagation —
counterpart of ``piecewise_icp_tpu/models/chaining.py`` (a numpy float64
copy: the JAX module imports ``jax.numpy`` through ``ops.transform``).

Walks the pair graph (adaptive map / fixed stride / direct), accumulates
T_ref = T_new · T_acc and propagates the VCM: through the SE(3) adjoint in
adaptive mode (Sigma <- Sigma_new + Ad Sigma Ad^T, Registration.cpp:
1056-1090), by addition in fixed-interval mode (:1094-1106).  A tiny
O(epochs) host scan.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.transform import adjoint_6x6, matrix_to_params_gon


def chain_to_reference(trans_mats: Sequence[np.ndarray],
                       vcms: Sequence[np.ndarray],
                       pair_mode: int,
                       reg_pairs: Dict[int, int] | None = None
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Accumulate each epoch's pairwise transform and VCM to the reference
    epoch.  ``trans_mats[i]`` / ``vcms[i]`` belong to source epoch ``i+1``
    (relative indices), the layout of TransMatrices.txt.

    pair_mode: 0 copies through (all direct); > 0 multiplies back with
    stride ``pair_mode`` and adds VCMs; < 0 walks ``reg_pairs`` (source ->
    target, relative indices) to epoch 0 with adjoint propagation.
    """
    n = len(trans_mats)
    out_t: List[np.ndarray] = []
    out_v: List[np.ndarray] = []
    for i in range(n):
        acc_t = np.asarray(trans_mats[i], dtype=np.float64).copy()
        acc_v = np.asarray(vcms[i], dtype=np.float64).copy()
        if pair_mode < 0:
            if reg_pairs is None:
                raise ValueError("adaptive chaining requires reg_pairs")
            target = i + 1
            for _ in range(i + 1):
                target = reg_pairs[target]
                if target == 0:
                    break
                t_new = np.asarray(trans_mats[target - 1], dtype=np.float64)
                acc_t = t_new @ acc_t
                ad = adjoint_6x6(t_new)
                acc_v = (np.asarray(vcms[target - 1], dtype=np.float64)
                         + ad @ acc_v @ ad.T)
        elif pair_mode > 0 and i >= pair_mode:
            acc_t = np.eye(4)
            acc_v = np.zeros((6, 6))
            idx = i
            while True:
                acc_t = np.asarray(trans_mats[idx], dtype=np.float64) @ acc_t
                acc_v = np.asarray(vcms[idx], dtype=np.float64) + acc_v
                if idx < pair_mode:
                    break
                idx -= pair_mode
        out_t.append(acc_t)
        out_v.append(acc_v)
    return out_t, out_v


def absolute_errors(estimated: Sequence[np.ndarray],
                    ground_truth: Sequence[np.ndarray]) -> np.ndarray:
    """Per-epoch |estimated - truth| in mgon / mm
    (``calAbsErrorOfTransPara``, Registration.cpp:1216-1248)."""
    rows = []
    for est, ref in zip(estimated, ground_truth):
        err = np.abs(matrix_to_params_gon(ref)
                     - matrix_to_params_gon(est)) * 1000.0
        rows.append(err)
    return np.array(rows)
