"""A request kind that the benchmark's tests register, not the benchmark:
an epoch fleet of the series, as ``piecewise_icp_torch.utils.scale``'s
``run_fleet`` runs one.  A request writes a configuration file, runs the
program's ``4d`` command line in ``workers`` children at once, shard i on
card ``devices[i mod len(devices)]`` with ``--shards W --shard i
--no-finalize``, then ``--shard 0 --resume`` on the first card.  With the
mix's ``pool`` the children are started in ``warm()`` and serve every
request (the first finalises), else each command line has a child of its
own.  The judge runs the same command line in one process and counts the
tables (``scale.FLEET_TABLES``) that differ from it by a byte."""

from __future__ import annotations

import os
import pathlib

from benchmark.child import ChildFailed
from benchmark.drive import program_config, write_ground_truth, write_pcd

THREADS = 2


class TinyFleet:
    def __init__(self, epochs, gt, config, traffic, workdir: pathlib.Path,
                 dev, seconds: float, devices=None, children=None):
        self.settings = dict(config["settings"])
        self.workers = int(traffic["workers"])
        self.mode = int(traffic["mode"])
        self.devices = devices
        self.children = children
        self.workdir = workdir
        self.n_epochs = len(epochs)
        self.scans = workdir / "scans"
        self.scans.mkdir(parents=True)
        for k, e in enumerate(epochs):
            write_pcd(self.scans / f"Epoch_{k + 1:03d}.pcd", e)
        self.gt_file = workdir / "defined_transformations.txt"
        write_ground_truth(self.gt_file, gt)
        self.campaigns = 0          # the warm one's folder is its own
        self.pool = None
        if traffic.get("pool"):
            self.pool = [self.start(i) for i in range(self.workers)]

    def start(self, i: int):
        card = self.devices[i % len(self.devices)]
        return self.children.start(card, threads=THREADS)

    def argv(self, out: pathlib.Path) -> list:
        """The fleet's command line of a campaign into ``out``."""
        out.mkdir(parents=True)
        conf = out.parent / (out.name + ".txt")
        program_config(dict(self.settings, path1=str(self.scans),
                            path2=str(out) + os.sep)
                       ).to_reference_file(conf)
        return ["4d", "--config", str(conf), "--epochs", str(self.n_epochs),
                "--mode", str(self.mode), "--epoch-digits", "3",
                "--epoch-prefix", "Epoch_", "--shards", str(self.workers),
                "--kalman", "--ground-truth", str(self.gt_file)]

    def warm(self) -> None:
        self.request(0)

    def request(self, k: int) -> dict:
        out = self.workdir / f"fleet_{self.campaigns:05d}"
        self.campaigns += 1
        argv = self.argv(out)
        shards = self.pool or [self.start(i) for i in range(self.workers)]
        for i, c in enumerate(shards):
            c.submit(argv + ["--shard", str(i), "--no-finalize",
                             "--device", c.card])
        failed = []
        for c in shards:
            try:
                c.wait()
            except ChildFailed as e:
                failed.append(e)
            if self.pool is None:
                c.close()
        if failed:
            raise failed[0]
        last = shards[0] if self.pool else self.start(0)
        last.submit(argv + ["--shard", "0", "--resume", "--device",
                            last.card])
        last.wait()
        if self.pool is None:
            last.close()
        return {"out": out, "argv": argv, "units": self.n_epochs - 1}

    def close(self) -> None:
        for c in self.pool or []:
            c.close()


def judge_fleet(answers, epochs, gt, cell, seed: int, dev) -> dict:
    from piecewise_icp_torch.__main__ import main
    from piecewise_icp_torch.utils.scale import FLEET_TABLES

    differ = 0
    if answers:
        one = answers[0]["out"].parent / "one_process"
        one.mkdir()
        argv = list(answers[0]["argv"])
        argv[argv.index("--shards") + 1] = "1"
        conf = pathlib.Path(argv[argv.index("--config") + 1])
        text = conf.read_text().replace(str(answers[0]["out"]), str(one))
        conf = one.parent / "one_process.txt"
        conf.write_text(text)
        argv[argv.index("--config") + 1] = str(conf)
        if main(argv + ["--device", str(dev)]) != 0:
            raise RuntimeError("the one-process campaign failed")
        for a in answers:
            differ += sum((a["out"] / name).read_bytes()
                          != (one / name).read_bytes()
                          for name in FLEET_TABLES)
    return {"tables_differ": differ, "answers_checked": len(answers)}


ENTRY = TinyFleet
JUDGE = judge_fleet
CHECKS = ("tables_differ",)
CONTROL = None
