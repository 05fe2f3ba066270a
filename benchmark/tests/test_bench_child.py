"""Command lines of the program in children of their own
(``benchmark/child.py``): an epoch fleet of the tiny series, two shard
children of the program's ``4d`` command line and then one ``--resume``,
exactly the fleet's command lines (``tests/kinds/tiny_fleet.py``).  In a
traced run every child's spans reach the run's context, the tables equal a
one-process campaign's byte for byte, a child that exits 1 fails its
request, and a child that loads a module named ``jax`` stops the run before
its line.  On the card the children's device operations carry their own
cards and the run's memory peak is the fullest card's, the peaks of the
processes on it summed."""

import json
import os

import pytest

from benchmark import harness
from benchmark.tests.tiny import add_cell, make_root

FLEET = {"entry": "tiny_fleet", "workers": 2, "mode": 1}
READERS = {
    # children whose spans closed in the window
    "child_spans": "def read(ctx):\n"
                   "    return len(set(ctx.span_procs) - {'harness'})\n",
    # children that wrote a report over the whole run
    "children": "def read(ctx):\n    return len(ctx.children)\n",
    "child_peak_bytes": "def read(ctx):\n"
                        "    return max(r['memory_peak_bytes']\n"
                        "               for r in ctx.children)\n",
    # the first card's peak (the harness and the children on it), and the
    # children's peaks summed on each of the first two cards
    "peak_cuda0": "def read(ctx):\n    return ctx.peaks.get('cuda:0')\n",
    "children_peak_cuda0": "def read(ctx):\n"
                           "    p = [r['memory_peak_bytes'] for r in"
                           " ctx.children if r['card'] == 'cuda:0']\n"
                           "    return sum(p) if p else None\n",
    "children_peak_cuda1": "def read(ctx):\n"
                           "    p = [r['memory_peak_bytes'] for r in"
                           " ctx.children if r['card'] == 'cuda:1']\n"
                           "    return sum(p) if p else None\n",
    # children with a device operation in the window, the cards those ran
    # on, and the share of them that ran on their child's own card
    "children_with_ops": "def read(ctx):\n"
                         "    return len({p for _, p in ctx.op_where})\n",
    "child_op_cards": "def read(ctx):\n"
                      "    return len({c for c, _ in ctx.op_where})\n",
    "child_ops_on_own_card": "def read(ctx):\n"
                             "    own = [c == ctx.procs[p]\n"
                             "           for c, p in ctx.op_where]\n"
                             "    return 100.0 * sum(own) / len(own)"
                             " if own else None\n",
}


def fleet_rc(tmp_path, capsys, seed, pool=False, fault=None,
             device="cpu", chips=1, traced=True):
    root = make_root(tmp_path)
    add_cell(root, "tiny.fleet", "tiny_fleet", dict(FLEET, pool=pool),
             {"tables_differ": 0}, "epochs_per_s", READERS, chips=chips)
    rc = harness.run("tiny.fleet", seed, 1.0, traced, 0.0, root=root,
                     device=device, look_for_chip=False, fault=fault)
    out, err = capsys.readouterr()
    return rc, out, err


def fleet_run(tmp_path, capsys, seed, **kw):
    rc, out, err = fleet_rc(tmp_path, capsys, seed, **kw)
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


def test_fleet_children_traced(tmp_path, capsys, kinds):
    line, err = fleet_run(tmp_path, capsys, 2**31 + 31)
    assert line["correct"] is True and line["failed"] == 0, err[-3000:]
    assert line["checks"]["tables_differ"] == {"value": 0, "limit": 0}
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # a request is two shard children and the one that finalises
    assert m["child_spans"] >= 3
    assert m["children"] == 3 * (line["attempted"] + 1)
    assert line["device"]["memory_peak_bytes"] == 0    # the CPU
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_fleet_untraced_line(tmp_path, capsys, kinds):
    line, _ = fleet_run(tmp_path, capsys, 2**31 + 33, traced=False)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"epochs_per_s", "setup_s"}


def _shard_one_fails(entry):
    """Shard 1's command line names a configuration file that is not
    there: that child answers 1."""
    start = entry.start

    def broken(i):
        child = start(i)
        if i == 1:
            submit = child.submit
            child.submit = lambda argv: submit(
                [a + ".missing" if a.endswith(".txt") else a for a in argv])
        return child
    entry.start = broken


def test_a_failing_child_fails_its_request(tmp_path, capsys, kinds):
    line, err = fleet_run(tmp_path, capsys, 2**31 + 35,
                          fault=_shard_one_fails, traced=False)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"] >= 1
    assert "child" in err and "(code 1)" in err


def test_a_child_that_loads_jax_stops_the_line(tmp_path, capsys, kinds,
                                               monkeypatch):
    """The children find a stub module named ``jax`` on their path and load
    it as they start (``sitecustomize``); this process never does.  The
    run prints no line and names the module and the child."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (stub / "sitecustomize.py").write_text("import jax  # noqa: F401\n")
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(stub)] + ([path] if path else [])))
    rc, out, err = fleet_rc(tmp_path / "run", capsys, 2**31 + 41,
                            pool=True, traced=False)
    assert rc != 0 and out.strip() == ""
    assert "jax (in child0)" in err and "jax (in child1)" in err


def test_peaks_summed_by_card():
    """Two children on one card add up with this process's peak there; the
    fullest card gives the line's peak."""
    reports = [{"card": "cuda:0", "memory_peak_bytes": 300},
               {"card": "cuda:0", "memory_peak_bytes": 400},
               {"card": "cuda:1", "memory_peak_bytes": 600}]
    peaks = harness.card_peaks({"cuda:0": 50, "cuda:1": 0}, reports)
    assert peaks == {"cuda:0": 750, "cuda:1": 600}
    assert harness.card_peaks({"cpu": 0}, []) == {"cpu": 0}


def test_a_warm_pool_serves_every_request(tmp_path, capsys, kinds):
    """Two children started in ``warm()`` serve every request and are
    closed after the window."""
    line, _ = fleet_run(tmp_path, capsys, 2**31 + 37, pool=True)
    assert line["correct"] is True and line["failed"] == 0
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["children"] == 2 and m["child_spans"] == 2


@pytest.mark.cuda
def test_children_on_their_cards(tmp_path, capsys, kinds, cuda):
    """Two children on ``cuda:0`` and ``cuda:1`` (both on ``cuda:0`` where
    one card is visible): their operations carry their cards, and the run's
    memory peak is the fullest card's, the peaks of the harness and of the
    children on it summed."""
    import torch

    chips = min(2, torch.cuda.device_count())
    line, _ = fleet_run(tmp_path, capsys, 2**31 + 39, pool=True,
                        device="cuda", chips=chips)
    with capsys.disabled():         # the line, for the record of a card run
        print(json.dumps(line))
    assert line["correct"] is True and line["failed"] == 0
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["children_with_ops"] == 2
    assert m["child_op_cards"] == chips
    assert m["child_ops_on_own_card"] == 100.0
    peak = line["device"]["memory_peak_bytes"]
    assert m["child_peak_bytes"] > 0
    assert m["peak_cuda0"] >= m["children_peak_cuda0"] >= m["child_peak_bytes"]
    if chips == 1:                  # both children's peaks on cuda:0
        assert peak == m["peak_cuda0"]
        assert m["children_peak_cuda0"] > m["child_peak_bytes"]
    else:
        assert peak == max(m["peak_cuda0"], m["children_peak_cuda1"])
    assert line["device"]["count"] == chips
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
