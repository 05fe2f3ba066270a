"""PyTorch port, the acceptance guard held against the JAX package's on the
reduced rockfall pair (epochs 1 and 2 of ``tests/test_torch_rockfall.py``'s
series), the JAX package's own ``register_pair`` on its TPU branch on the
CPU (``jax_tpu_branch``).  The guard re-draws the seed lattice when the
final stable ratio falls below ``guard_stable_ratio``, decides from one
probe draw whether to escalate to ``guard_draws``, and GLS-fuses the three
draws with the lowest sigma0.  Three cases:

* the default configuration: the ratio stays above 0.35, one draw (this is
  also the pair on the unified path, held against the JAX package);
* ``guard_stable_ratio=0.9, guard_draws=3``: the guard fires, the probe
  disagrees beyond 2 sigma and it escalates to 3 draws;
* the same with ``guard_escalate_z=100``: it fuses the probe pair only.

Each draw of either package is recorded by wrapping its core
(``record_draws``): the JAX ``RegistrationOutput`` carries no draw count.
"""

import numpy as np
import pytest

import piecewise_icp_torch.models.pairwise as t_pairwise
from piecewise_icp_tpu.ops.transform import matrix_to_angles

from piecewise_icp_torch.utils import rockfall

from test_torch_rockfall import (EPOCHS, EXTENT, RES, corner_gap,
                                 j_pairwise, jax_tpu_branch, record_draws,
                                 rockfall_cfgs, series_pair)

CASES = {
    "default": ({}, 1),
    "escalates": (dict(guard_stable_ratio=0.9, guard_draws=3), 3),
    "probe_only": (dict(guard_stable_ratio=0.9, guard_draws=3,
                        guard_escalate_z=100.0), 2),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rockfall"))
    rockfall.generate_rockfall(root, EPOCHS, extent=EXTENT, res=RES)
    return root, *series_pair(root)


@pytest.fixture(scope="module")
def runs(pair):
    """Each case's pair in both packages, run once a module: (JAX draws,
    JAX result, port draws, port result, source cloud)."""
    root, scans, c1, c2, _ = pair
    done = {}

    def run(case: str):
        if case not in done:
            jcfg, cfg = rockfall_cfgs(scans, root + "/", **CASES[case][0])
            with jax_tpu_branch() as jdraws:
                ref = j_pairwise.register_pair(
                    c1, c2, jcfg, sor_mult=jcfg.sor_std_mult_pair)
            with record_draws(t_pairwise) as tdraws:
                got = t_pairwise.register_pair(
                    c1, c2, cfg, sor_mult=cfg.sor_std_mult_pair,
                    device="cpu")
            done[case] = (jdraws, ref, tdraws, got, c2)
        return done[case]

    return run


def probe_z(draws) -> float:
    """The guard's disagreement of the first draw and the probe, in units
    of their own standard errors (``pairwise.py``'s ``z_dis``)."""
    (_, t0, v0), (_, t1, v1) = draws[:2]
    p0 = np.concatenate([matrix_to_angles(t0), t0[:3, 3]])
    p1 = np.concatenate([matrix_to_angles(t1), t1[:3, 3]])
    se2 = np.diag(v0) + np.diag(v1)
    return float(np.max(np.abs(p0 - p1) / np.sqrt(np.maximum(se2, 1e-24))))


def test_unified_pair_matches_jax(runs):
    """The default pair on the unified path (SOR and segmentation on one
    grid) within 0.5 mm at the source's box corners of the JAX package's,
    each draw's VCM diagonal within 1e-3 relative."""
    jdraws, ref, tdraws, got, c2 = runs("default")
    assert len(jdraws) == len(tdraws) == 1
    assert corner_gap(got.trans_mat, ref.trans_mat, c2) < 5e-4
    assert np.allclose(np.diag(got.vcm), np.diag(ref.vcm), rtol=1e-3)
    assert got.core.num_patches == tuple(ref.core.num_patches)


@pytest.mark.parametrize("case", list(CASES))
def test_guard_matches_jax(runs, case):
    """The same draws, the same escalation decision, the same sigma0 order
    of the fused draws, the fused transform within 0.5 mm at the box
    corners, the reported VCM's diagonal within 1e-3 relative."""
    over, n_draws = CASES[case]
    jdraws, ref, tdraws, got, c2 = runs(case)
    assert len(jdraws) == len(tdraws) == got.guard_draws == n_draws
    if n_draws > 1:
        z = over.get("guard_escalate_z", 2.0)
        zj, zt = probe_z(jdraws), probe_z(tdraws)
        assert (zj > z) == (zt > z) == (case == "escalates"), (zj, zt)
        order_j = np.argsort([s for s, _, _ in jdraws])[:3]
        order_t = np.argsort([s for s, _, _ in tdraws])[:3]
        assert list(order_j) == list(order_t)
        for (_, tj, _), (_, tt, _) in zip(jdraws, tdraws):
            assert corner_gap(tt, tj, c2) < 5e-4
    assert corner_gap(got.trans_mat, ref.trans_mat, c2) < 5e-4
    assert np.allclose(np.diag(got.vcm), np.diag(ref.vcm), rtol=1e-3)
