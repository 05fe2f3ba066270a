"""Typed errors replacing the reference's mid-pipeline ``std::exit`` calls.

The reference aborts the whole process on degenerate geometry
(Registration.cpp:728-731, :864-867; Segmentation.cpp:142-145) and on
unreadable intermediate files (Registration.cpp:986-988, :1018-1021).
Per-pair failures inside the 4D loop are soft (print + continue,
Registration.cpp:145-147).  Here every failure is a typed exception so the
4D campaign loop can skip a pair without killing the fleet.  The port's
own copy of ``piecewise_icp_tpu/utils/errors.py``.
"""

from __future__ import annotations


class PwICPError(RuntimeError):
    """Base class for all Piecewise-ICP pipeline errors."""


class DegenerateGeometryError(PwICPError):
    """Too few patches / stable patches to estimate a rigid transform.

    Reference behaviour: ``std::exit(EXIT_FAILURE)`` when fewer than 4
    patches (Registration.cpp:728-731) or fewer than 4 stable patches
    (Registration.cpp:864-867) remain.
    """


class FileFormatError(PwICPError):
    """Malformed PCD / config / intermediate result file."""


class RegistrationFailedError(PwICPError):
    """A pairwise registration did not produce a usable transform."""
