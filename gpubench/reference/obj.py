"""The reference's own reader of the benchmark's OBJ meshes: plain Python,
independent of the port's ``io/obj.py`` and of its native parser.

It reads what the benchmark writes (``harness.inputs.write_obj``) and no
more: ``v``, ``vt`` and ``vn`` lines and triangle faces of 1-based
``v/vt/vn`` indices, as a triangle soup of float32 numpy arrays, a vertex
a corner. Anything else it meets in a face raises.
"""
from __future__ import annotations

import numpy as np


def load(path):
    """(positions f32[N, 3], uvs f32[N, 2], normals f32[N, 3]) of the OBJ
    file at ``path``, N = 3 x its triangles."""
    v, vt, vn, corners = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                v.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vt.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                if len(parts) != 4:
                    raise ValueError(f"{path}: a face that is no triangle: "
                                     f"{line.strip()!r}")
                for corner in parts[1:]:
                    idx = corner.split("/")
                    if len(idx) != 3 or not all(idx):
                        raise ValueError(f"{path}: a corner that is not "
                                         f"v/vt/vn: {corner!r}")
                    corners.append([int(k) for k in idx])
    c = np.asarray(corners, np.int64).reshape(-1, 3)
    out = []
    for table, col in ((v, 0), (vt, 1), (vn, 2)):
        a = np.asarray(table, np.float32)
        k = c[:, col] - 1
        if ((k < 0) | (k >= len(a))).any():
            raise ValueError(f"{path}: an index out of range")
        out.append(a[k])
    return tuple(out)
