"""Command-line interface of the PyTorch port.

    python -m piecewise_icp_torch pair --config conf.txt --out results/PairReg/
    python -m piecewise_icp_torch 4d --config conf.txt --epochs 20 --mode -1
    python -m piecewise_icp_torch 4d ... --kalman --shards 4 --shard 1

The two entry points of the reference (Registration.h:36,49), on
``--device`` (``cuda`` by default, ``cpu`` for the plain versions).
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

    p_4d = sub.add_parser("4d", help="4D time-series registration")
    p_4d.add_argument("--config", required=True)
    p_4d.add_argument("--start-epoch", type=int, default=0)
    p_4d.add_argument("--epochs", type=int, required=True)
    p_4d.add_argument("--mode", type=int, default=-1,
                      help="0: direct-to-ref; >0 fixed interval; <0 adaptive")
    p_4d.add_argument("--overlap-thd", type=float, default=0.75)
    p_4d.add_argument("--ground-truth", default=None)
    p_4d.add_argument("--kalman", action="store_true")
    p_4d.add_argument("--shard", type=int, default=0,
                      help="this worker's shard index in an epoch fleet")
    p_4d.add_argument("--shards", type=int, default=1,
                      help="total workers splitting the pair list")
    p_4d.add_argument("--resume", action="store_true",
                      help="reuse finished pairs from <out>/pairs/*.npz")
    p_4d.add_argument("--no-finalize", action="store_true",
                      help="skip chaining/accuracy (another shard will)")
    for p in (p_pair, p_4d):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        p.add_argument("--reference-semantics", action="store_true",
                       help="disable the beyond-reference accuracy "
                            "features (change screen, acceptance guard, "
                            "robust refine, direct-mode warm start)")
        p.add_argument("--icp-variant", default=None,
                       choices=["reference", "symmetric"],
                       help="inner-ICP objective (default: config value)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.reference_semantics:
        overrides.update(change_screen=False, guard_enabled=False,
                         robust_refine=False, warm_start_direct=False)
    if args.icp_variant:
        overrides["icp_variant"] = args.icp_variant

    if args.cmd == "pair":
        from .models.pairwise import piecewise_icp_pair_call
        ok = piecewise_icp_pair_call(args.config, args.out,
                                     device=args.device, **overrides)
    else:
        from .models.four_d import piecewise_icp_4d_call
        if args.kalman:
            overrides["kalman_enabled"] = True
        ok = piecewise_icp_4d_call(args.config, args.start_epoch,
                                   args.epochs, args.mode, args.overlap_thd,
                                   ground_truth=args.ground_truth,
                                   shard_index=args.shard,
                                   shard_count=args.shards,
                                   resume=args.resume,
                                   finalize=not args.no_finalize,
                                   device=args.device, **overrides)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
