"""Device resolution and numeric precision for the PyTorch port.

Every entry point takes a ``device`` whose default is ``"cuda"``; nothing
here sets a global default device.  ``"cuda"`` requires a visible GPU and
raises otherwise — there is no silent downgrade to the CPU; the plain
versions run only for a caller who names ``"cpu"``.

TF32 is switched off for matrix products and convolutions: it keeps ~3
decimal digits, which silently breaks millimetre geometry at metre scale.
This is the counterpart of the JAX package's ``precision="highest"``.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device: "str | torch.device") -> torch.device:
    """Turn ``"cuda"``, ``"cuda:N"`` or ``"cpu"`` into a torch.device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def fetch(*tensors: torch.Tensor) -> list:
    """ONE device-to-host transfer for several tensors: each is flattened
    to float64 (exact for float32, bool and int32 values), concatenated,
    copied once, and split back into numpy arrays of the original shapes
    and dtypes."""
    import numpy as np

    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        dt = {torch.bool: np.bool_, torch.int32: np.int32,
              torch.int64: np.int64, torch.float32: np.float32,
              torch.float64: np.float64}[t.dtype]
        out.append(host[o:o + n].reshape(tuple(t.shape)).astype(dt))
        o += n
    return out
