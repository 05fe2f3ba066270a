"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``piecewise_icp_torch/csrc/*.cu`` and are compiled at
first use by ``nvcc`` — one process per source, all started together, then
one link — into ONE shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).  The
library goes to ``piecewise_icp_torch/_build/<hash>/``, keyed by a
content hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is reused.  The parallel build keeps the build a small
share of a smoke run's time limit as kernels are added.

Nothing here runs at import time: ``nvcc`` and the GPU are touched only
when a wrapper is handed a CUDA tensor.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), and every plain version that is handed a CUDA
tensor counts in :data:`PLAIN_ON_CUDA`, so a run can show which path its
work took.  Loading and counting are guarded by one lock: the 4D campaign
prepares the next epoch on a worker thread while the current pair runs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpwicp_torch.so"

# -fmad=false: no FMA contraction, so squared distances and the VCCS metric
# round exactly like the plain versions and the JAX reference (ties decided
# by == must agree bit for bit).
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-Xptxas",
                           "-v", "-Xcompiler", "-fPIC"]

LAUNCHES: "collections.Counter[str]" = collections.Counter()
PLAIN_ON_CUDA: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_GRID_ARGS = [_P, _P, _I, _F, _F, _F, _F, _I, _I, _I]

_SIGNATURES = {
    "pwicp_range_nn1": [_P, _P, _I] + _GRID_ARGS + [_P, _P, _P, _P, _P],
    "pwicp_knn_sorted": [_P, _I] + _GRID_ARGS + [_P, _P, _P, _P],
    "pwicp_seg_stats": [_P, _I, _F] + _GRID_ARGS + [_P, _P, _P],
    "pwicp_prop_round": [_P, _P, _P, _F, _F, _I] + _GRID_ARGS + [_P, _P, _P],
    "pwicp_propagate": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _I] + _GRID_ARGS
    + [_P, _P, _P, _P, _P, _P],
    "pwicp_propagate_ctrl": [_I],
    "pwicp_nn1_brute": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "pwicp_nn1_tile": [],
    "pwicp_knn_brute": [_P, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P],
    "pwicp_knn_brute_cap": [_I, _I, _I],
    "pwicp_knn_brute_layout": [_I, _I, _I, _P],
    "pwicp_knn_cap": [],
    "pwicp_seg_cap": [],
    "pwicp_prop_cap": [],
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_seconds: float | None = None
build_log: str = ""


def reset_counts() -> None:
    with _lock:
        LAUNCHES.clear()
        PLAIN_ON_CUDA.clear()


def note_plain(name: str, t: torch.Tensor) -> None:
    """Record that the plain version ``name`` ran on ``t``'s device."""
    if t.is_cuda:
        with _lock:
            PLAIN_ON_CUDA[name] += 1


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_key() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "piecewise_icp_torch cannot be built")


def library_path() -> pathlib.Path:
    return BUILD_ROOT / _source_key() / LIB_NAME


def build() -> pathlib.Path:
    """Compile the kernel library unless an up-to-date build exists.

    Processes that start together (the workers of an epoch fleet) take an
    exclusive lock on ``_build/<hash>.lock`` and look again under it, so
    one compiles and the others load its library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        return _compile(out)


def _compile(out: pathlib.Path) -> pathlib.Path:
    global build_seconds, build_log
    import time

    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [pr.communicate()[0] for pr in procs]
        failed = [pr.args[-1] for pr in procs if pr.returncode != 0]
        so = os.path.join(tmp, LIB_NAME)
        if not failed:
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so,
                                   *objs], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        (out.parent / "build.log").write_text(build_log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               f"{build_log}")
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def launch(name: str, counters: "str | tuple[str, ...]", *args,
           device: torch.device) -> None:
    """Call C entry ``name`` on ``device`` (that of the operands), on its
    current stream; raise on a launch error.  Each of ``counters`` gains
    one."""
    here = device.index in (None, torch.cuda.current_device())
    with contextlib.nullcontext() if here else torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _lock:
        for c in (counters,) if isinstance(counters, str) else counters:
            LAUNCHES[c] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None,
          contiguous: bool = True) -> None:
    """Validate a kernel operand (CUDA, dtype, shape, contiguity; a
    wrapper whose kernel reads the operand by its stride waives the
    last)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
