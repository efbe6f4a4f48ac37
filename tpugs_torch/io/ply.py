"""Minimal PLY codec for 3DGS point clouds (no plyfile dependency).
Counterpart: ``tpugs/io/ply.py``.

Supports the Inria 3DGS export layout: binary little-endian vertex
element with float properties ``x y z``, ``f_dc_0..2``,
``f_rest_0..44``, ``opacity``, ``scale_0..2``, ``rot_0..3`` (plus any
extras, preserved by name).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the ``vertex`` element into a dict of per-property arrays."""
    with open(path, "rb") as fh:
        header: List[str] = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        if fmt not in ("binary_little_endian", "ascii"):
            raise NotImplementedError(f"PLY format {fmt}")

        n_vertex = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise NotImplementedError("list properties")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))

        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, dt) for name, dt in props])
            data = np.frombuffer(fh.read(dtype.itemsize * n_vertex), dtype=dtype)
        else:
            raw = np.loadtxt(fh, max_rows=n_vertex)
            data = np.rec.fromarrays(
                raw.T, dtype=[(name, dt) for name, dt in props]
            )
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian vertex element from named float
    columns (all columns must share the same length)."""
    names = list(fields)
    n = len(fields[names[0]])
    cols = {k: np.asarray(v, np.float32).reshape(n) for k, v in fields.items()}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.empty(n, dtype=dtype)
    for name in names:
        rec[name] = cols[name]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(rec.tobytes())
