"""Helpers of the PyTorch port that import neither JAX nor the JAX package
(the names of ``piecewise_icp_tpu.utils``)."""

from .errors import (DegenerateGeometryError, FileFormatError, PwICPError,
                     RegistrationFailedError)
from .logging import PhaseTimer, log

__all__ = ["DegenerateGeometryError", "FileFormatError", "PwICPError",
           "RegistrationFailedError", "PhaseTimer", "log"]
