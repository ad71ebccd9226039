"""Minimal PLY reader (no external deps) for ScanNet meshes: the port's
copy of ``gapro_tpu/data/ply.py``.

Supports ascii and binary_little_endian with the vertex properties ScanNet
uses (x/y/z float, red/green/blue uchar [, alpha, label]) and int vertex_indices
face lists — enough for `*_vh_clean_2.ply` and `*_labels.ply`.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Returns dict with 'vertex' (structured array) and 'face' ([M,3] int64)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)] or ("list", idx_t, val_t, name))
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", _TYPES[parts[2]], _TYPES[parts[3]], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _TYPES[parts[1]]))

        out = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # face element: assume single list property of 3 indices
                faces = np.empty((count, 3), np.int64)
                if fmt == "ascii":
                    for i in range(count):
                        vals = f.readline().split()
                        k = int(vals[0])
                        faces[i] = [int(x) for x in vals[1 : 1 + min(k, 3)]]
                else:
                    _, idx_t, val_t, _ = props[0]
                    for i in range(count):
                        k = int(np.frombuffer(f.read(np.dtype(idx_t).itemsize), idx_t)[0])
                        vals = np.frombuffer(f.read(k * np.dtype(val_t).itemsize), val_t)
                        faces[i] = vals[:3]
                out[name] = faces
            else:
                dt = np.dtype([(p, t) for p, t in props])
                if fmt == "ascii":
                    rows = [tuple(f.readline().split()[: len(props)]) for _ in range(count)]
                    arr = np.array(rows, dtype=[(p, "f8") for p, _ in props]).astype(dt)
                else:
                    arr = np.frombuffer(f.read(count * dt.itemsize), dt)
                out[name] = arr
        return out
