"""The drop-in C ABI of the port (``pwicp_capi.cpp``).

:func:`build_capi` compiles a shared library exposing the reference DLL's
two symbols, ``PiecewiseICP_pair_call`` and ``PiecewiseICP_4D_call``,
which call :func:`piecewise_icp_torch.piecewise_icp_pair_call` and
:func:`piecewise_icp_torch.piecewise_icp_4d_call` through the embedded (or
the already running) Python interpreter.  Load it with ``ctypes`` exactly
as the reference's ``python/main.py`` loads its DLL.

The C symbols take no device, so the library reads one from the
environment variable ``PWICP_TORCH_DEVICE`` at each call: ``cuda`` (the
card) where it is unset or empty, ``cpu`` for the kernels' plain versions.
It is the only setting of the port that comes from the environment
rather than an argument, because the reference's C signatures leave no
other way.

The library is built by ``g++`` at first use into
``piecewise_icp_torch/_build/capi-<hash>/``, keyed by the source, the
flags and the interpreter, so an unchanged source is reused.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sysconfig
import tempfile

_HERE = pathlib.Path(__file__).resolve().parent
CAPI_SRC = _HERE / "pwicp_capi.cpp"
BUILD_ROOT = _HERE.parent / "_build"
CAPI_LIB = "libpwicp_torch_capi.so"


class NativeBuildError(RuntimeError):
    """The C ABI library could not be built (no ``g++``, no ``Python.h``,
    no ``libpython``, or a compiler error)."""


def _capi_command(src: str, out: str) -> list[str]:
    """The reference's ``build_capi`` flags: the interpreter's headers and
    its ``libpython``."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    return ["g++", "-O2", "-shared", "-fPIC", src, f"-I{inc}", f"-L{libdir}",
            f"-lpython{ver}", "-o", out]


def build_capi() -> str:
    """Build (if needed) the C ABI library and return its path for
    ``ctypes.cdll.LoadLibrary``.  Raises :class:`NativeBuildError` when it
    cannot be built."""
    h = hashlib.sha256(CAPI_SRC.read_bytes())
    h.update(" ".join(_capi_command("", "")).encode())
    out = BUILD_ROOT / f"capi-{h.hexdigest()[:16]}" / CAPI_LIB
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, CAPI_LIB)
        try:
            subprocess.run(_capi_command(str(CAPI_SRC), so), check=True,
                           capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeBuildError(
                f"capi build failed: {getattr(e, 'stderr', None) or e}"
            ) from e
        os.replace(so, out)   # atomic: concurrent builds agree
    return str(out)
