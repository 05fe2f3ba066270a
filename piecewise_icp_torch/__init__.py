"""piecewise_icp_torch — Piecewise-ICP pairwise and 4D registration in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``piecewise_icp_tpu`` (JAX/Pallas for TPU), which stays in the
repository as the reference.  It follows the reference's TPU branch on
every device; on the CPU the kernels' plain PyTorch versions run in their
place.  It imports neither JAX nor anything of the JAX package: its
``config``, ``io`` and ``utils`` are its own copies.  Every entry point
runs on the card (``device="cuda"``) unless the caller names another
device, and raises when no GPU is visible.

>>> import piecewise_icp_torch as pwt
>>> pwt.piecewise_icp_pair_call("config_pair.txt", "results/PairReg/")
>>> pwt.piecewise_icp_4d_call("config_4d.txt", start_epoch=0, epoch_num=20,
...                           pair_mode=-1)
"""

from .config import ARC_TO_GON, ConfigError, PiecewiseICPConfig

from . import device as _device  # noqa: F401  (sets float32 precision)

__version__ = "0.1.0"

__all__ = ["ARC_TO_GON", "ConfigError", "PiecewiseICPConfig",
           "register_pair", "piecewise_icp_pair_call", "run_4d",
           "piecewise_icp_4d_call"]


def __getattr__(name):
    if name in ("register_pair", "piecewise_icp_pair_call"):
        from .models import pairwise
        return getattr(pairwise, name)
    if name in ("run_4d", "piecewise_icp_4d_call"):
        from .models import four_d
        return getattr(four_d, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
