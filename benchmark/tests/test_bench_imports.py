"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program either."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "piecewise_icp_tpu"}


def imported_tops(*paths: pathlib.Path) -> set:
    """Top-level names of the absolute imports of the files or folders."""
    tops = set()
    for path in paths:
        for p in [path] if path.is_file() else path.rglob("*.py"):
            for node in ast.walk(ast.parse(p.read_text())):
                if isinstance(node, ast.Import):
                    tops.update(a.name.split(".")[0] for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    tops = imported_tops(ROOT / "benchmark" / "reference")
    assert not tops & (FORBIDDEN | {"piecewise_icp_torch"}), tops


def test_harness_sources_name_no_jax():
    bench = ROOT / "benchmark"
    tops = imported_tops(*(p for p in bench.iterdir()
                           if p.name not in ("tests", "reference")))
    assert not tops & FORBIDDEN, tops


def test_loaded_modules_of_a_run():
    """Everything a run loads (harness, entries, program, reference,
    readers) in a fresh process: no forbidden top-level name."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import harness, drive, judge, trace, control, child\n"
        "import benchmark.entries.pair, benchmark.entries.campaign\n"
        "import piecewise_icp_torch.models.pairwise\n"
        "import piecewise_icp_torch.models.four_d\n"
        "import benchmark.reference.models.pairwise\n"
        "import benchmark.reference.models.chaining\n"
        "import benchmark.reference.models.kalman\n"
        "c = harness.Cell('synthetic.pair_stream')\n"
        "[c.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "piecewise_icp_torch" in tops
