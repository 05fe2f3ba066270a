"""One run of one cell of the benchmark of piecewise_icp_torch, on the
CUDA device of the machine it starts on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It prints the result as the last line of its standard output (see
``benchmark/harness.py``), and exits with another code than 0, printing
no result, where no CUDA device is visible or the program is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from benchmark import harness

    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
