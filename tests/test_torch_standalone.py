"""PyTorch port, stand-alone: the package, every module under it (its
``parallel`` package included), its CLI and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package (``piecewise_icp_tpu``), and
a registration runs with both blocked."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "piecewise_icp_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FOREIGN = ("piecewise_icp_tpu", "jax", "jaxlib")


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", PORT_SOURCES, ids=[str(p.relative_to(ROOT)) for p in PORT_SOURCES])
def test_no_import_statement_names_the_jax_package(path):
    """Source scan: no ``import`` / ``from ... import`` of the port names
    JAX or the JAX package (comments and docstrings may)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if n.split(".")[0] in FOREIGN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_the_jax_package_blocked():
    """In a fresh interpreter with ``piecewise_icp_tpu``, ``jax`` and
    ``jaxlib`` blocked: import the package, every module under it and
    ``__main__``, then register a tiny pair on the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("piecewise_icp_tpu", "jax", "jaxlib"):
            sys.modules[name] = None
        import numpy as np
        import piecewise_icp_torch as pwt
        names = [m.name for m in pkgutil.walk_packages(
            pwt.__path__, pwt.__name__ + ".")]
        assert "piecewise_icp_torch.__main__" in names, names
        assert "piecewise_icp_torch.io.formats" in names, names
        assert "piecewise_icp_torch.parallel.distributed" in names, names
        for name in names:
            importlib.import_module(name)
        from piecewise_icp_torch.utils.synth import make_pair
        c1, c2, t_true = make_pair(
            np.random.default_rng(0),
            [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005], n_side=60)
        cfg = pwt.PiecewiseICPConfig(res1=0.022, res2=0.022,
                                     svsize1=0.22, svsize2=0.22,
                                     guard_enabled=False)
        out = pwt.register_pair(c1, c2, cfg, device="cpu")
        assert out.trans_mat.shape == (4, 4)
        assert np.isfinite(out.trans_mat).all()
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("piecewise_icp_tpu", "jax", "jaxlib")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
