"""piecewise_icp_torch — Piecewise-ICP pairwise registration in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``piecewise_icp_tpu`` (JAX/Pallas for TPU), which stays in the
repository as the reference.  It follows the reference's TPU branch on
every device; on the CPU the kernels' plain PyTorch versions run in their
place.  It imports no JAX, and of the JAX package only the JAX-free
``config``, ``io`` and ``utils`` modules.

>>> import piecewise_icp_torch as pwt
>>> pwt.piecewise_icp_pair_call("config_pair.txt", "results/PairReg/",
...                             device="cuda")
"""

from piecewise_icp_tpu.config import ConfigError, PiecewiseICPConfig

from . import device as _device  # noqa: F401  (sets float32 precision)

__all__ = ["ConfigError", "PiecewiseICPConfig", "register_pair",
           "piecewise_icp_pair_call"]


def __getattr__(name):
    if name in ("register_pair", "piecewise_icp_pair_call"):
        from .models import pairwise
        return getattr(pairwise, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
