"""PLY point-cloud I/O for 3D Gaussian Splatting scenes.

A numpy copy of :mod:`rtgs_tpu.io.ply` (which cannot be imported without
JAX): a dependency-free parser for the canonical 62-property 3DGS schema
(``x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..44,opacity,scale_0..2,rot_0..3``).
Binary bodies are one ``np.frombuffer``. The threaded C++ deinterleave of
the JAX package (``rtgs_tpu/io/plyfast.cpp``) is not ported yet.
"""

from __future__ import annotations

import io
import os
import pathlib
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(stream) -> Tuple[str, int, List[Tuple[str, str]], int]:
    """Parse a PLY header; returns (format, vertex_count, properties,
    header_len_bytes). Only the ``vertex`` element is supported."""
    magic = stream.readline()
    if magic.strip() != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    count = 0
    props: List[Tuple[str, str]] = []
    in_vertex = False
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing 'format'")
    return fmt, count, props, stream.tell()


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file's vertex element into ``{property_name: (N,) array}``.
    Supports ``binary_little_endian``, ``binary_big_endian`` and ``ascii``."""
    with open(pathlib.Path(path), "rb") as f:
        fmt, count, props, _ = _parse_header(f)
        if fmt == "ascii":
            data = np.loadtxt(io.BytesIO(f.read()), dtype=np.float64, ndmin=2)
            if data.shape != (count, len(props)):
                raise ValueError(
                    f"ascii body shape {data.shape} != ({count}, {len(props)})")
            return {n: data[:, i].astype(dt)
                    for i, (n, dt) in enumerate(props)}
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + dt) for n, dt in props])
        raw = f.read(count * dtype.itemsize)
        if len(raw) < count * dtype.itemsize:
            raise ValueError("truncated PLY body")
        rec = np.frombuffer(raw, dtype=dtype, count=count)
        return {n: np.ascontiguousarray(rec[n]) for n, _ in props}


def write_ply(path, columns: Dict[str, np.ndarray],
              fmt: str = "binary_little_endian") -> None:
    """Write vertex properties to a PLY file (one row per point);
    ``columns`` insertion order is the property order."""
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    arrays = {k: np.asarray(v) for k, v in columns.items()}
    for k, v in arrays.items():
        if v.shape != (n,):
            raise ValueError(f"column {k} has shape {v.shape}, want ({n},)")

    inv_types = {"f4": "float", "f8": "double", "i4": "int", "u1": "uchar",
                 "i1": "char", "i2": "short", "u2": "ushort", "u4": "uint"}
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    for k in names:
        header.append(f"property {inv_types[arrays[k].dtype.str[1:]]} {k}")
    header.append("end_header\n")

    path = pathlib.Path(path)
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if fmt == "ascii":
            mat = np.stack([arrays[k].astype(np.float64) for k in names], 1)
            np.savetxt(f, mat, fmt="%.9g")
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dtype = np.dtype(
                [(k, endian + arrays[k].dtype.str[1:]) for k in names])
            rec = np.empty(n, dtype=dtype)
            for k in names:
                rec[k] = arrays[k]
            f.write(rec.tobytes())
