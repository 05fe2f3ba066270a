"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the nearest precision below the one the
configuration states (TF32 matrix products for float32 ones with TF32
off), judged by the same numbers as a run, at the cell's own sizes, on the
card:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

It prints one JSON line a seed with the numbers the run would compare,
and their limits; the benchmark's runs never run it.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.say("no CUDA device is visible: no control run")
        return 2
    cell = harness.Cell(args.workload)
    harness.quiet_logs()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        epochs, gt = harness.make_inputs(cell.config, seed)
        line = {"workload": cell.name, "seed": seed,
                "checks": control_checks(cell, epochs, gt, seed, dev)}
        line["seconds"] = time.perf_counter() - t0
        line["limits"] = cell.limits["limits"]
        print(json.dumps(line), flush=True)
    return 0


def control_checks(cell, epochs, gt, seed: int, dev) -> dict:
    """The numbers of a run in which every request of the window was
    answered by the reference with TF32 on."""
    from benchmark import judge

    if cell.traffic["entry"] == "campaign":
        return control_campaign(cell, epochs, gt, seed, dev)
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


def control_campaign(cell, epochs, gt, seed: int, dev) -> dict:
    """A campaign answered by the reference with TF32 on: its plan, its
    sampled pairs, and the chained and smoothed series of its pairs.  The
    pairs the judge does not sample enter both sides' series alike, so
    they stand as the ground truth's pair transforms with the sampled
    pairs' mean VCM instead of being registered."""
    from benchmark import judge
    from benchmark.reference.models.plan import adaptive_pair_sequence

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

if __name__ == "__main__":
    sys.exit(main())
