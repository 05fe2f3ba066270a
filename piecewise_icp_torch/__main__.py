"""Command-line interface of the PyTorch port.

    python -m piecewise_icp_torch pair --config conf.txt --out results/PairReg/

Only the pairwise entry point is ported; the 4D campaign is not
(see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="piecewise_icp_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_pair = sub.add_parser("pair", help="pairwise registration")
    p_pair.add_argument("--config", required=True)
    p_pair.add_argument("--out", required=True,
                        help="output file prefix (like results/PairReg/)")
    p_pair.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    p_pair.add_argument("--reference-semantics", action="store_true",
                        help="disable the beyond-reference accuracy "
                             "features (acceptance guard, robust refine)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.reference_semantics:
        overrides.update(guard_enabled=False, robust_refine=False)
    from .models.pairwise import piecewise_icp_pair_call
    ok = piecewise_icp_pair_call(args.config, args.out, device=args.device,
                                 **overrides)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
