"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the nearest precision below the one the
configuration states (TF32 matrix products for float32 ones with TF32
off), judged by the same numbers as a run, at the cell's own sizes, on the
card:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

It prints one JSON line a seed with the numbers the run would compare,
and their limits; the benchmark's runs never run it.  The control of each
request kind is its module's ``CONTROL`` (``benchmark/entries/``).
"""

import argparse
import json
import pathlib
import sys
import time


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
    kind = cell.kind()
    harness.quiet_logs()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        epochs, gt = harness.make_inputs(cell.config, seed)
        line = {"workload": cell.name, "seed": seed,
                "checks": kind.CONTROL(cell, epochs, gt, seed, dev)}
        line["seconds"] = time.perf_counter() - t0
        line["limits"] = cell.limits["limits"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
