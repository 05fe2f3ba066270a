"""Multi-controller demo: H host launchers, each spawning N ranks, register
one pair point-sharded over all H x N ranks — counterpart of
``eval/distributed_demo.py``.

    python -m piecewise_icp_torch.parallel.demo [--hosts 2] [--nproc 2]
        [--device cuda] [--backend nccl|gloo] [--n-side 378] [--res R]
        [--out distributed_report.json]

Each host launcher is a process of its own (``--host H``, internal) that
runs :func:`~.distributed.launch` with its host index, the host count and
the rendezvous address, ``tcp://127.0.0.1:<free port>``, as one launcher a
host of a real job would.  Under NCCL host h sees only its own cards
(``CUDA_VISIBLE_DEVICES``: cards h*N to h*N+N-1 of those visible here);
under gloo every host sees every card, so ranks may share one.  The pair
is ``utils.synth.make_pair`` of seed 0 over a 2 m square (at the default
``--n-side``, ``chip_smoke.py``'s 142,884-point smoke pair), registered by the staged loop on the raw clouds
with the default configuration, or with ``--res R`` (SV 10 R).

The JSON report has the keys of ``eval/distributed_report.json``: ``ok``,
``cross_process_param_diff`` (the largest difference between the
transforms of any two ranks of any hosts; it must be 0) and one entry a
host under ``workers`` (its rank counts, ``params_gon_m``, residuals
against the known transform, iterations and the pair's seconds), with the
transform's bits, the VCM, each rank's device, the cards it holds a CUDA
context on (its own alone, or ``ok`` is false) and its start-up, and the
demo's wall.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import PiecewiseICPConfig
from ..ops.transform import apply_transform_np, matrix_to_params_gon
from .distributed import context_devices, launch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the transform of eval/distributed_demo.py (and chip_smoke.py)
PARAMS = (0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005)
DEFAULT_TIMEOUT_S = 600.0


def demo_pair(n_side: int = 378, res: "float | None" = None):
    """(cloud1, cloud2, T_true, config) of the demo."""
    from ..utils.synth import make_pair

    c1, c2, t_true = make_pair(np.random.default_rng(0), PARAMS,
                               n_side=n_side)
    cfg = PiecewiseICPConfig() if res is None else PiecewiseICPConfig(
        res1=res, res2=res, svsize1=10 * res, svsize2=10 * res)
    return c1, c2, t_true, cfg


def register_on_ranks(group, c1, c2, cfg, t0: float) -> dict:
    """One rank: the staged loop on the pair, point-sharded over
    ``group``; every rank's transform, device, the cards it holds a CUDA
    context on, and start-up (``t0``: the wall clock at the demo's start)
    gathered."""
    from ..models.piecewise_icp import piecewise_icp

    started_s = time.time() - t0
    dev = group.device
    tic = time.perf_counter()
    res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg, device=dev,
                        group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - tic
    ranks = group.gather_object(dict(
        rank=group.rank, device=str(dev), contexts=context_devices(),
        pid=os.getpid(), started_s=started_s,
        trans_mat=res.trans_mat.tolist()))
    return dict(trans_mat=res.trans_mat, vcm=res.vcm,
                iterations=res.iterations, seconds=seconds, ranks=ranks)


def worker_report(out: dict, host: int, hosts: int, nproc: int,
                  t_true: np.ndarray, c2: np.ndarray) -> dict:
    """A host launcher's entry of the report (the keys of
    ``eval/distributed_demo.py``'s workers, and the transform's bits)."""
    m = out["trans_mat"] @ t_true
    c2 = c2.astype(np.float64)
    disp = np.linalg.norm(apply_transform_np(c2, m) - c2, axis=1)
    return {
        "process_id": host,
        "process_count": hosts,
        "global_devices": hosts * nproc,
        "local_devices": nproc,
        "params_gon_m": matrix_to_params_gon(out["trans_mat"]).tolist(),
        "mean_residual_mm": float(disp.mean() * 1000),
        "max_residual_mm": float(disp.max() * 1000),
        "iterations": int(out["iterations"]),
        "seconds": out["seconds"],
        "trans_mat": out["trans_mat"].tolist(),
        "vcm": out["vcm"].tolist(),
        "ranks": out["ranks"],
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_cards(hosts: int, nproc: int) -> list:
    """Each host's ``CUDA_VISIBLE_DEVICES`` under NCCL: its own N cards of
    those visible here."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(i) for i in range(torch.cuda.device_count())])
    if len(cards) < hosts * nproc:
        raise RuntimeError(f"nccl runs one card a rank: {hosts} hosts x "
                           f"{nproc} ranks, {len(cards)} CUDA device(s) "
                           "visible")
    return [",".join(cards[h * nproc:(h + 1) * nproc]) for h in range(hosts)]


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(max(os.path.getsize(path) - n, 0))
        return f.read().decode(errors="replace")


def run(c1, c2, t_true, cfg, hosts: int = 2, nproc: int = 2,
        device: str = "cuda", backend: "str | None" = None,
        address: "str | None" = None,
        timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Register ``c2`` onto ``c1`` over ``hosts`` host launchers of
    ``nproc`` ranks each, started as processes of their own that meet at
    ``address`` (default ``tcp://127.0.0.1:<free port>``), and return the
    report.  Raises with the launchers' logs where one fails, and kills
    every launcher and rank once ``timeout`` seconds have passed."""
    if hosts < 2:
        raise ValueError("the demo runs 2 or more host launchers")
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    # under gloo every host sees every card (ranks may share one)
    cards = (_host_cards(hosts, nproc) if backend == "nccl"
             else [None] * hosts)
    if dev_type == "cuda":
        from ..ops import _cuda
        _cuda.build()       # once, before the launchers
    address = address or f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.time()
    tic = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pwicp_demo_") as tmp:
        inputs = os.path.join(tmp, "inputs.pkl")
        with open(inputs, "wb") as f:
            pickle.dump((c1, c2, t_true, cfg, timeout), f)
        procs, logs, reports = [], [], []
        try:
            for h in range(hosts):
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                    [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
                if cards[h] is not None:
                    env["CUDA_VISIBLE_DEVICES"] = cards[h]
                reports.append(os.path.join(tmp, f"host{h}.json"))
                logs.append(os.path.join(tmp, f"host{h}.log"))
                with open(logs[-1], "wb") as log_f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __spec__.name, "--host",
                         str(h), "--hosts", str(hosts), "--nproc",
                         str(nproc), "--address", address, "--device",
                         device, "--backend", backend, "--inputs", inputs,
                         "--report", reports[-1], "--t0", repr(t0)],
                        env=env, stdout=log_f, stderr=subprocess.STDOUT,
                        start_new_session=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{hosts} host launchers still "
                                       f"running after {timeout:g} s")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError("host launchers failed:\n" + "\n".join(
                f"--- host {h} (exit {p.returncode}):\n{_tail(logs[h])}"
                for h, p in enumerate(procs)))
        workers = []
        for path in reports:
            with open(path) as f:
                workers.append(json.load(f))
    wall_s = time.perf_counter() - tic
    mats = [np.asarray(r["trans_mat"]) for w in workers for r in w["ranks"]]
    diff = max(float(np.abs(m - mats[0]).max()) for m in mats)
    # a rank on a card holds a context on that card alone
    own = all(r["contexts"] == ([torch.device(r["device"]).index]
                                if r["device"].startswith("cuda") else [])
              for w in workers for r in w["ranks"])
    ok = (diff == 0.0 and own
          and all(len(w["ranks"]) == hosts * nproc
                  and w["process_count"] == hosts
                  and w["global_devices"] == hosts * nproc
                  and w["mean_residual_mm"] < 2.0 for w in workers))
    return {"ok": ok, "cross_process_param_diff": diff, "backend": backend,
            "address": address, "wall_s": wall_s, "workers": workers}


def _host_main(args) -> int:
    """One host launcher: its ``nproc`` ranks of the job, and its entry
    of the report."""
    with open(args.inputs, "rb") as f:
        c1, c2, t_true, cfg, timeout = pickle.load(f)
    out = launch(register_on_ranks, args.nproc, c1, c2, cfg, args.t0,
                 device=args.device, backend=args.backend,
                 timeout=timeout, host=args.host, hosts=args.hosts,
                 address=args.address)
    report = worker_report(out, args.host, args.hosts, args.nproc, t_true,
                           c2)
    with open(args.report + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(args.report + ".tmp", args.report)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m " + __spec__.name,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--nproc", type=int, default=2, help="ranks a host")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on cuda) or gloo")
    ap.add_argument("--n-side", type=int, default=378)
    ap.add_argument("--res", type=float, default=None,
                    help="resolution of both clouds (SV 10 times it; "
                    "default: the configuration's)")
    ap.add_argument("--out", default="distributed_report.json")
    # a host launcher (started by the demo, or one a host of a real job)
    ap.add_argument("--host", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--report", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.host is not None:
        return _host_main(args)
    c1, c2, t_true, cfg = demo_pair(args.n_side, args.res)
    report = run(c1, c2, t_true, cfg, args.hosts, args.nproc, args.device,
                 args.backend)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("ok", "cross_process_param_diff",
                                             "wall_s")}
                     | {"mean_residual_mm":
                        report["workers"][0]["mean_residual_mm"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    # the launcher's ranks unpickle register_on_ranks by the module's name
    from piecewise_icp_torch.parallel.demo import main as _main
    sys.exit(_main())
