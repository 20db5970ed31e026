"""PLY point-cloud I/O (reference N14: loadPLYSimple/writePLY,
ppf_helpers.hpp:64-71).

Supports ASCII and binary-little-endian PLY with x/y/z (+ optional
nx/ny/nz) float properties — the subset the reference reads/writes.
Pure numpy; no external dependencies. A copy of
object_detector_6d_tpu/io/ply.py.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_PROP_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
}


def load_ply(path: str, with_normals: Optional[bool] = None) -> np.ndarray:
    """Load vertices -> [N, 3] or [N, 6] f32 (xyz [+ normals if present])."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    fmt = "ascii"
    n_vertex = 0
    props = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties not supported in vertex element")
            props.append((parts[2], parts[1]))
    names = [p[0] for p in props]
    has_normals = all(n in names for n in ("nx", "ny", "nz"))
    want_normals = has_normals if with_normals is None else with_normals
    cols = ["x", "y", "z"] + (["nx", "ny", "nz"] if want_normals and has_normals else [])

    if fmt == "ascii":
        body = data[header_end:].decode("ascii")
        arr = np.fromstring(body, sep=" ") if False else np.array(body.split(), np.float64)
        arr = arr.reshape(n_vertex, len(props))
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        dtype = np.dtype([(n, "<" + _PROP_TYPES[t][0]) for n, t in props])
        arr_struct = np.frombuffer(data, dtype=dtype, count=n_vertex, offset=header_end)
        arr = np.stack([arr_struct[n].astype(np.float64) for n in names], -1)
    out = np.stack([arr[:, names.index(c)] for c in cols], -1)
    return out.astype(np.float32)


def write_ply(path: str, cloud: np.ndarray, binary: bool = True) -> None:
    """Write [N, 3] or [N, 6] points (+normals) as PLY."""
    cloud = np.asarray(cloud, np.float32)
    n, c = cloud.shape
    names = ["x", "y", "z"] + (["nx", "ny", "nz"] if c >= 6 else [])
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {n}")
    header += [f"property float {nm}" for nm in names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(cloud[:, : len(names)], "<f4").tobytes())
        else:
            np.savetxt(f, cloud[:, : len(names)], fmt="%.6f")
