"""PyTorch port, its namespaces against the JAX package's: every name in
the ``__all__`` of ``piecewise_icp_tpu`` and of its ``models``, ``ops``,
``utils``, ``io`` and ``parallel`` is an attribute of the port's twin (and
in its ``__all__``), or a row of the exclusion table below with its reason;
``ARC_TO_GON`` and ``__version__`` agree; ``import piecewise_icp_torch``
stays light and the namespaces build no kernel."""

import ast
import importlib
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMESPACES = ["", "models", "ops", "utils", "io", "parallel"]

# (namespace, JAX name) -> why the port has no twin
EXCLUDED = {
    ("models", "estimate_normals"): "ROADMAP 'Do not port': the host normals "
    "of the non-TPU branch (models/segmentation.py:110); the port follows "
    "the TPU branch, whose normals come from K3",
    ("ops", "cov3_from_points"): "ROADMAP 'Do not port': only tests call it "
    "(ops/eigh3.py:95)",
    ("ops", "grid_knn"): "ROADMAP 'Do not port': an XLA-gather grid path; "
    "the CSR-walk kernels (K1, K2) replace it",
    ("ops", "grid_nn1"): "ROADMAP 'Do not port': an XLA-gather grid path; "
    "K1 replaces it",
    ("ops", "grid_percentile"): "ROADMAP 'Do not port': an XLA-gather grid "
    "path; the stage-1 percentile runs on K1",
    ("ops", "knn"): "ROADMAP 'Do not port': ops/nn.py; "
    "nn_cuda.knn_distances replaces it",
    ("ops", "nn1"): "ROADMAP 'Do not port': ops/nn.py; K5 nn1_brute "
    "replaces it",
    ("ops", "nn1_pallas"): "ROADMAP 'Do not port': K5 nn1_brute replaces it",
}
# (namespace, JAX name) -> the port's name for the same role
RENAMED = {
    ("parallel", "make_mesh"): "make_group",
    ("parallel", "build_sharded_iteration"): "ShardGroup",
}


def jax_all(ns: str) -> list:
    """``__all__`` of the JAX package's namespace, read from its source
    (nothing of JAX is imported)."""
    path = ROOT / "piecewise_icp_tpu" / ns / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) \
                and getattr(node.targets[0], "id", None) == "__all__":
            return [e.value for e in node.value.elts]
    raise AssertionError(f"{path} has no __all__")


def port(ns: str):
    return importlib.import_module(
        "piecewise_icp_torch" + (f".{ns}" if ns else ""))


@pytest.mark.parametrize("ns", NAMESPACES,
                         ids=[ns or "top" for ns in NAMESPACES])
def test_every_jax_name_has_a_twin(ns):
    mod = port(ns)
    missing = []
    for name in jax_all(ns):
        if (ns, name) in EXCLUDED:
            continue
        twin = RENAMED.get((ns, name), name)
        if not hasattr(mod, twin) or twin not in mod.__all__:
            missing.append(twin)
    assert not missing, f"piecewise_icp_torch.{ns} lacks {missing}"


def test_every_table_row_names_a_jax_name():
    for ns, name in list(EXCLUDED) + list(RENAMED):
        assert name in jax_all(ns), (ns, name)
    assert all(EXCLUDED.values())


def test_constants_and_version():
    import piecewise_icp_tpu
    import piecewise_icp_torch

    assert piecewise_icp_torch.ARC_TO_GON == piecewise_icp_tpu.ARC_TO_GON
    assert piecewise_icp_torch.__version__ == piecewise_icp_tpu.__version__
    assert f'version = "{piecewise_icp_torch.__version__}"' in \
        (ROOT / "pyproject.toml").read_text()


def test_drop_in_imports():
    from piecewise_icp_torch.models import piecewise_icp, run_4d
    from piecewise_icp_torch.models.four_d import run_4d as run_4d_def
    from piecewise_icp_torch.ops import eigh3, transform
    from piecewise_icp_torch.utils import PhaseTimer

    assert run_4d is run_4d_def and callable(piecewise_icp)
    assert callable(eigh3) and hasattr(transform, "matrix_to_params_gon")
    assert PhaseTimer().total() == 0


def test_imports_build_nothing():
    """A fresh interpreter: ``import piecewise_icp_torch`` loads only its
    configuration and device modules; the namespaces then load no kernel
    library, build nothing and open no CUDA context."""
    code = textwrap.dedent("""
        import sys
        import torch
        import piecewise_icp_torch
        loaded = sorted(m for m in sys.modules
                        if m.startswith("piecewise_icp_torch"))
        assert loaded == ["piecewise_icp_torch", "piecewise_icp_torch.config",
                          "piecewise_icp_torch.device"], loaded
        for ns in ("models", "ops", "utils", "io", "parallel"):
            __import__("piecewise_icp_torch." + ns)
        from piecewise_icp_torch.ops import _cuda
        assert _cuda._lib is None and _cuda.build_seconds is None
        assert not torch.cuda.is_initialized()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
