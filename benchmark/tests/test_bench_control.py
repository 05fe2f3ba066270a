"""The control of each configuration's comparison, on the card at a test
size: the reference with TF32 matrix products, judged against the
reference as the cell's runs judge the program, fails the cell's limits.
The benchmark's runs never run it; ``benchmark/control.py`` runs it at
the cells' own sizes."""

import pytest

from benchmark import harness, judge
from benchmark.reference.utils.errors import PwICPError

pytestmark = pytest.mark.cuda

# a 3-epoch series of each configuration at a size a test run holds
SMALL = {"synthetic.pair_stream": {"n_epochs": 3, "n_side": 200},
         "rockfall.pair_stream": {"n_epochs": 3, "extent": [60.0, 40.0]}}


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_tf32_control_fails_the_limits(cuda, cell_name):
    cell = harness.Cell(cell_name)
    harness.quiet_logs()
    gen = dict(cell.config["generator"])
    gen["args"] = dict(gen["args"], **SMALL[cell_name])
    epochs, _ = harness.make_inputs(dict(cell.config, generator=gen),
                                    2**31 + 77)
    settings = cell.config["settings"]
    sound = judge.judge_pairs([dict(judge.reference_pair(epochs, 0,
                                                         settings, cuda),
                                    pair=0)],
                              epochs, settings, dict(checked_pairs=1),
                              0, cuda)
    assert sound["pose_gap_mm"] == 0.0 and sound["sigma_gap"] == 0.0
    try:
        with judge.matmul_tf32(True):
            low = judge.reference_pair(epochs, 0, settings, cuda)
    except PwICPError:
        return      # the control raised: a failed request, so not correct
    control = judge.judge_pairs([dict(low, pair=0)], epochs, settings,
                                dict(checked_pairs=1), 0, cuda)
    limits = cell.limits["limits"]
    assert (control["pose_gap_mm"] > limits["pose_gap_mm"]
            or control["sigma_gap"] > limits["sigma_gap"]), control
