"""Command lines of the program, each in a process of its own on one card,
measured there as the harness measures its own process.

A request kind that drives the program through its command line (an epoch
fleet's shard processes and the pass that finalises) starts children from
the :class:`Children` the harness gives it::

    child = children.start("cuda:1")        # the process, torch, the card
    child.submit(["4d", "--config", ...])    # one command line of the program
    child.wait()                             # raises ChildFailed unless 0
    child.close()                            # it ends and writes its report

A child serves one command line or several in turn: one started in
``warm()`` and closed after the window is a worker pool kept warm.  Each
child is this module run from the repository's root as::

    python3 -m benchmark.child --card <cuda:i|cpu> --report <file>
        [--threads <n>] [--trace]

It reads one JSON request a line on its standard input (``{"argv":
[...]}``), runs ``piecewise_icp_torch.__main__.main(argv)`` on its card and
answers ``{"rc": <code>}`` on the standard output it was started with;
whatever the program prints goes to its standard error, a log file beside
its report.  With ``--trace`` it stamps the program's spans and profiles
its card with the functions of :mod:`benchmark.trace` the harness uses,
both on ``time.time_ns()``, so the processes of one host share one clock.
At the end of its input it writes its report (:func:`serve`), which names
the modules of JAX or of the JAX package it has loaded, and exits with
the first non-zero code it answered, or 0.
"""

from __future__ import annotations

import time

ENTERED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# what a failure's message keeps of the child's log
LOG_TAIL = 3000
# seconds a child has to end once its input has ended
CLOSE_S = 120


class ChildFailed(RuntimeError):
    """A child answered a command line with another code than 0, exited
    with one, or ended without answering."""

    def __init__(self, child: "Child", rc: Optional[int], what: str):
        tail = ""
        if child.log_path.exists():
            tail = child.log_path.read_text(errors="replace")[-LOG_TAIL:]
        super().__init__(f"{child.label} on {child.card}: {what} "
                         f"(code {rc}); its log ends:\n{tail}")


class Child:
    """One child process on one card (see the module's doc)."""

    def __init__(self, folder: pathlib.Path, label: str, card: str,
                 threads: Optional[int], traced: bool):
        self.label = label
        self.card = card
        self.report_path = folder / f"{label}.json"
        self.log_path = folder / f"{label}.log"
        cmd = [sys.executable, "-m", "benchmark.child", "--card", card,
               "--report", str(self.report_path)]
        env = dict(os.environ)
        if threads:
            cmd += ["--threads", str(threads)]
            env["OMP_NUM_THREADS"] = str(threads)
        if traced:
            cmd.append("--trace")
        self.report: Optional[dict] = None
        self.rc: Optional[int] = None
        self._ready = False
        self._blamed = False        # a ChildFailed was raised for it
        self.started = time.time()
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log, cwd=ROOT, env=env, text=True, bufsize=1)

    def _answer(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            self._blamed = True
            raise ChildFailed(self, self.proc.wait(), "ended without an "
                              "answer")
        return json.loads(line)

    def ready(self) -> None:
        """Wait until the child has loaded the program and taken its
        card."""
        if not self._ready:
            self._answer()
            self._ready = True

    def submit(self, argv: List[str]) -> None:
        """Hand the child one command line of the program; it runs while
        the caller goes on."""
        self.ready()
        try:
            self.proc.stdin.write(json.dumps({"argv": list(argv)}) + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            self._blamed = True
            raise ChildFailed(self, self.proc.wait(), "ended before its "
                              "command line") from None

    def wait(self) -> None:
        """Wait for the answer to the command line submitted last; raise
        :class:`ChildFailed` unless it is 0."""
        rc = int(self._answer()["rc"])
        if rc != 0:
            self._blamed = True
            raise ChildFailed(self, rc, "a command line returned non-zero")

    def close(self) -> None:
        """End the child's input, wait for it to end (killing it after
        ``CLOSE_S`` seconds) and read its report.  Raises
        :class:`ChildFailed` where it exited non-zero and no failure of it
        was raised before."""
        if self.rc is not None:
            return
        try:
            self.proc.stdin.close()
        except BrokenPipeError:
            pass
        try:
            self.rc = self.proc.wait(timeout=CLOSE_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.rc = self.proc.wait()
        self.proc.stdout.close()
        if self.report_path.exists():
            self.report = dict(json.loads(self.report_path.read_text()),
                               started=self.started)
        if self.rc != 0 and not self._blamed:
            self._blamed = True
            raise ChildFailed(self, self.rc, "exited non-zero")


class Children:
    """The children of one run: started by its entry, their reports under
    ``folder``, traced when the run is."""

    def __init__(self, folder: pathlib.Path, traced: bool):
        self.folder = folder
        self.traced = traced
        self.all: List[Child] = []

    def start(self, card, threads: Optional[int] = None) -> Child:
        """A new child on ``card`` (``cuda:i`` or ``cpu``) that runs the
        program's command lines on ``threads`` intra-op threads (torch's
        default where None)."""
        self.folder.mkdir(parents=True, exist_ok=True)
        child = Child(self.folder, f"child{len(self.all)}", str(card),
                      threads, self.traced)
        self.all.append(child)
        return child

    def close(self) -> List[ChildFailed]:
        """Close every child still open; the failures of those that exited
        non-zero."""
        failed = []
        for child in self.all:
            try:
                child.close()
            except ChildFailed as e:
                failed.append(e)
        return failed

    def reports(self) -> List[dict]:
        """The reports of the children that wrote one, in their order."""
        return [c.report for c in self.all if c.report is not None]


def serve(args) -> int:
    """The child's side: load the program, take the card, answer command
    lines until the input ends, then write the report: ``label``, ``card``,
    ``pid``, ``rc`` (the exit code), ``rcs`` (a command line each),
    ``entered`` (``time.time()`` when this file began to run) and ``ready``
    (when the program was loaded and the card taken),
    ``memory_peak_bytes`` (``torch.cuda.max_memory_allocated`` of the card;
    0 on the CPU) and ``forbidden`` (the loaded modules of JAX or of the
    JAX package, by :func:`benchmark.harness.forbidden_modules`); traced,
    also ``records`` (the program's stamped span records), ``ops``
    (``[name's index, start ns, end ns, card]`` of every device operation
    the profiler saw) and ``op_names``."""
    answer = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)                   # the program's prints go to the log
    sys.stdout = sys.stderr
    import logging

    import torch

    from benchmark import trace
    from benchmark.harness import forbidden_modules

    card = torch.device(args.card)
    if args.threads:
        torch.set_num_threads(args.threads)
    import piecewise_icp_torch.utils.logging as program_logging
    from piecewise_icp_torch.__main__ import main as program

    logging.getLogger("piecewise_icp_torch").setLevel(logging.WARNING)
    if card.type == "cuda":
        from piecewise_icp_torch.ops import _cuda

        torch.cuda.set_device(card)
        _cuda.lib()
        torch.zeros(1, device=card)
    profile, seen = None, None
    if args.trace:
        records = trace.stamp_spans(program_logging.GLOBAL_TIMER)
        profile = trace.device_profile(card.type == "cuda")
        seen = profile.__enter__()
    report = {"label": pathlib.Path(args.report).stem, "card": str(card),
              "pid": os.getpid(), "entered": ENTERED, "ready": time.time()}
    answer.write(json.dumps({"ready": True}) + "\n")
    rcs = []
    for line in sys.stdin:
        argv = json.loads(line)["argv"]
        try:
            rc = program(argv) or 0
        except SystemExit as e:     # argparse's refusal
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:           # the program raised: a failed request
            traceback.print_exc()
            rc = 1
        if card.type == "cuda":
            torch.cuda.synchronize(card)
        rcs.append(int(rc))
        answer.write(json.dumps({"rc": int(rc)}) + "\n")
    rc = next((c for c in rcs if c), 0)
    if profile is not None:
        profile.__exit__(None, None, None)
        names = {}
        report["ops"] = [[names.setdefault(n, len(names)), s, e, c]
                         for (n, s, e), c in zip(seen["ops"], seen["cards"])]
        report["op_names"] = list(names)
        report["records"] = list(records)
    report.update(rc=rc, rcs=rcs, memory_peak_bytes=int(
        torch.cuda.max_memory_allocated(card) if card.type == "cuda" else 0),
        forbidden=forbidden_modules())
    tmp = pathlib.Path(args.report).with_suffix(".part")
    tmp.write_text(json.dumps(report, default=str))
    os.replace(tmp, args.report)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", required=True)
    ap.add_argument("--report", required=True)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
