"""PCD (Point Cloud Data) reader / writer.

Replaces ``pcl::io::loadPCDFile`` / ``savePCDFileBinary`` used throughout the
reference (Registration.cpp:87, :128, :252-253, :394).  Supports the PCD v0.7
header with ``ascii``, ``binary`` and ``binary_compressed`` data sections and
arbitrary scalar fields; xyz are returned as a dense float32 ``[N, 3]`` array
(the shape every device op in this framework consumes).

The benchmark data ships as ``FIELDS x y z``, ``TYPE F F F``, binary
(data_synthetic/*.pcd headers).

The port's own copy of ``piecewise_icp_tpu/io/pcd.py``; the LZF codec of
the ``binary_compressed`` mode is pure Python here (that package's native
host library is not used).
"""

from __future__ import annotations

import io as _io
import pathlib
from typing import Dict, Tuple

import numpy as np

from ..utils.errors import FileFormatError

_TYPE_MAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def _parse_header(raw: bytes) -> Tuple[Dict, int]:
    """Parse the PCD header; returns (header dict, byte offset of data)."""
    hdr: Dict = {}
    offset = 0
    stream = _io.BytesIO(raw)
    while True:
        line = stream.readline()
        if not line:
            raise FileFormatError("PCD header truncated (no DATA line)")
        offset += len(line)
        text = line.decode("ascii", errors="replace").strip()
        if not text or text.startswith("#"):
            continue
        key, _, rest = text.partition(" ")
        key = key.upper()
        hdr[key] = rest.split()
        if key == "DATA":
            break
    for req in ("FIELDS", "SIZE", "TYPE", "COUNT", "POINTS", "DATA"):
        if req not in hdr:
            raise FileFormatError(f"PCD header missing {req}")
    return hdr, offset


def _header_dtype(hdr: Dict) -> np.dtype:
    names, formats = [], []
    fields = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr["COUNT"]]
    for name, size, typ, cnt in zip(fields, sizes, types, counts):
        base = _TYPE_MAP.get((typ, size))
        if base is None:
            raise FileFormatError(f"unsupported PCD field type {typ}{size}")
        if cnt == 1:
            names.append(name)
            formats.append(base)
        else:
            for k in range(cnt):
                names.append(f"{name}_{k}")
                formats.append(base)
    # make duplicate / underscore names unique for structured dtype
    seen: Dict[str, int] = {}
    uniq = []
    for n in names:
        if n in seen or n == "_":
            seen[n] = seen.get(n, 0) + 1
            uniq.append(f"{n}__{seen[n]}")
        else:
            seen[n] = 0
            uniq.append(n)
    return np.dtype({"names": uniq, "formats": formats})


def _lzf_decompress(data: bytes, out_len: int) -> bytes:
    """LZF decode (pure Python)."""
    out = bytearray(out_len)
    ip, op, n = 0, 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:                       # literal run
            run = ctrl + 1
            if ip + run > n or op + run > out_len:
                raise ValueError("literal run overruns buffer")
            out[op:op + run] = data[ip:ip + run]
            ip += run
            op += run
        else:                               # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[ip]
                ip += 1
            length += 2
            ref = op - ((ctrl & 0x1f) << 8) - data[ip] - 1
            ip += 1
            if ref < 0 or op + length > out_len:
                raise ValueError("back reference out of range")
            for i in range(length):         # overlap-safe byte copy
                out[op + i] = out[ref + i]
            op += length
    if op != out_len:
        raise ValueError(f"decoded {op} of {out_len} bytes")
    return bytes(out)


def _lzf_compress(data: bytes) -> bytes:
    """LZF encode as a valid literal-only stream (any LZF decoder reads
    it; it is just not smaller)."""
    out = bytearray()
    for s in range(0, len(data), 32):
        chunk = data[s:s + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def read_pcd(path: str | pathlib.Path) -> np.ndarray:
    """Read a PCD file and return float32 xyz points of shape ``[N, 3]``.

    Points with non-finite coordinates are dropped (PCL marks invalid returns
    as NaN; the reference's dense synthetic data has none).
    """
    raw = pathlib.Path(path).read_bytes()
    hdr, offset = _parse_header(raw)
    n_points = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()
    dtype = _header_dtype(hdr)

    if mode == "ascii":
        body = raw[offset:].decode("ascii", errors="replace")
        flat = np.array(body.split(), dtype=np.float64)
        ncols = len(dtype.names)
        if flat.size < n_points * ncols:
            raise FileFormatError("PCD ascii body truncated")
        table = flat[: n_points * ncols].reshape(n_points, ncols)
        cols = {name: table[:, i] for i, name in enumerate(dtype.names)}
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    elif mode == "binary":
        body = raw[offset: offset + n_points * dtype.itemsize]
        if len(body) < n_points * dtype.itemsize:
            raise FileFormatError("PCD binary body truncated")
        rec = np.frombuffer(body, dtype=dtype, count=n_points)
        xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    elif mode == "binary_compressed":
        # PCL layout (pcl::io::loadPCDFile, lzf_image_io): two uint32 LE
        # (compressed size, uncompressed size), LZF stream, and the
        # UNCOMPRESSED data is field-major (all x, then all y, ...).
        if len(raw) < offset + 8:
            raise FileFormatError("PCD binary_compressed body truncated")
        comp_len, full_len = np.frombuffer(raw, dtype="<u4", count=2,
                                           offset=offset)
        body = raw[offset + 8: offset + 8 + int(comp_len)]
        if len(body) < comp_len:
            raise FileFormatError("PCD binary_compressed body truncated")
        try:
            data = _lzf_decompress(body, int(full_len))
        except ValueError as e:
            raise FileFormatError(f"PCD LZF stream corrupt: {e}") from e
        cols: Dict[str, np.ndarray] = {}
        pos = 0
        for name in dtype.names:
            sub = np.dtype(dtype.fields[name][0])
            end = pos + n_points * sub.itemsize
            cols[name] = np.frombuffer(data[pos:end], dtype=sub)
            pos = end
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    else:
        raise FileFormatError(f"unknown PCD data mode: {mode}")

    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    if not finite.all():
        xyz = xyz[finite]
    return xyz


def write_pcd(path: str | pathlib.Path, points: np.ndarray,
              binary: bool = True, compressed: bool = False) -> None:
    """Write ``[N, 3]`` float32 xyz points as PCD v0.7.

    Matches the layout produced by ``pcl::io::savePCDFileBinary``
    (Registration.cpp:394) for xyz clouds; ``compressed=True`` emits the
    ``binary_compressed`` mode (LZF over field-major data,
    ``savePCDFileBinaryCompressed`` layout).
    """
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError("points must have shape [N, 3]")
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
    )
    path = pathlib.Path(path)
    if compressed:
        soa = np.ascontiguousarray(pts.T).tobytes()   # field-major
        comp = _lzf_compress(soa)
        with open(path, "wb") as f:
            f.write((header + "DATA binary_compressed\n").encode("ascii"))
            f.write(np.array([len(comp), len(soa)],
                             dtype="<u4").tobytes())
            f.write(comp)
    elif binary:
        with open(path, "wb") as f:
            f.write((header + "DATA binary\n").encode("ascii"))
            f.write(pts.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header + "DATA ascii\n")
            for p in pts:
                f.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
