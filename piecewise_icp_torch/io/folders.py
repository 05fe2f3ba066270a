"""Epoch folder scanning and timestamp extraction.

Replaces the Windows-only ``_findfirst``/``_findnext`` recursive listing and
``Epoch_NNN`` timestamp parse of the reference (CommonFunc.cpp:182-236) with
portable pathlib code.  Files are sorted ascending by the numeric timestamp
extracted after a configurable prefix, exactly like
``extractAllFilesFromFolder`` (CommonFunc.cpp:194-206).

The port's own copy of ``piecewise_icp_tpu/io/folders.py``.
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Tuple

from ..utils.errors import FileFormatError


def extract_time_from_filename(name: str, prefix: str = "Epoch_",
                               digits: int = 3) -> int:
    """Numeric timestamp following ``prefix`` (CommonFunc.cpp:231-236).

    Mirrors the reference: take exactly ``digits`` characters after the
    prefix and parse as an integer.
    """
    idx = name.find(prefix)
    if idx < 0:
        raise FileFormatError(f"no '{prefix}' in file name: {name}")
    start = idx + len(prefix)
    chunk = name[start:start + digits]
    m = re.match(r"\d+", chunk)
    if not m:
        raise FileFormatError(f"no numeric timestamp in: {name}")
    return int(m.group(0))


def scan_epoch_folder(folder: str | pathlib.Path, prefix: str = "Epoch_",
                      digits: int = 3,
                      suffix: str = ".pcd") -> Tuple[List[str], List[int]]:
    """Recursively list scans under ``folder``, sorted by epoch timestamp.

    Returns (file paths, timestamps) like ``extractAllFilesFromFolder``
    (CommonFunc.cpp:182-208).
    """
    folder = pathlib.Path(folder)
    if not folder.is_dir():
        raise FileFormatError(f"not a folder: {folder}")
    files = [p for p in sorted(folder.rglob(f"*{suffix}")) if p.is_file()]
    stamped = [(str(p), extract_time_from_filename(p.name, prefix, digits))
               for p in files]
    stamped.sort(key=lambda x: x[1])
    return [s[0] for s in stamped], [s[1] for s in stamped]
