"""Wavefront OBJ loader and writer (BASELINE config 3: ~100k-triangle
assets), the torch counterpart of ``metalrenderer_tpu.io.obj``.

A file becomes a triangle-soup ``Mesh`` (positions, uvs and normals
expanded per corner) on the CPU, polygons fan-triangulated, missing
normals generated from the face planes. The native parser
(``io/native.py``) reads it when it is available, else the Python loader.
"""
from __future__ import annotations

import numpy as np

from ..scene.mesh import Mesh, from_numpy


def load_obj(path, use_native=True) -> Mesh:
    """Load an OBJ: the C++ parser if ``use_native`` and it is available,
    else pure Python. The mesh lies on the CPU."""
    if use_native:
        from .native import parse_obj_native
        parsed = parse_obj_native(path)
        if parsed is not None:
            return from_numpy(*parsed)
    return _load_obj_python(path)


def _load_obj_python(path) -> Mesh:
    positions, uvs, normals = [], [], []
    f_pos, f_uv, f_nrm = [], [], []

    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for c in line.split()[1:]:
                    comps = c.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    idx.append((vi, ti, ni))
                # Fan triangulation preserves winding.
                for k in range(1, len(idx) - 1):
                    for vi, ti, ni in (idx[0], idx[k], idx[k + 1]):
                        f_pos.append(vi)
                        f_uv.append(ti)
                        f_nrm.append(ni)

    positions = np.asarray(positions, np.float32)
    uvs = np.asarray(uvs, np.float32) if uvs else np.zeros((1, 2), np.float32)
    normals = np.asarray(normals, np.float32) if normals else None

    def resolve(indices, source, n_items):
        out = np.zeros((len(indices), source.shape[1]), np.float32)
        for i, raw in enumerate(indices):
            if raw > 0:
                out[i] = source[raw - 1]
            elif raw < 0:
                out[i] = source[n_items + raw]
        return out

    pos = resolve(f_pos, positions, len(positions))
    uv = resolve(f_uv, uvs, len(uvs))[:, :2]
    if normals is not None and any(n != 0 for n in f_nrm):
        nrm = resolve(f_nrm, normals, len(normals))
    else:
        # Flat normals from the face planes (CCW winding).
        p = pos.reshape(-1, 3, 3)
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        nrm = np.repeat(n / np.maximum(norm, 1e-20), 3, axis=0)
    return from_numpy(pos, uv, nrm)


def save_obj(path, mesh: Mesh):
    """Write a triangle-soup mesh, one v/vt/vn per corner, each float32 in
    its shortest round-trip decimal form, so the file reads back bit-equal."""
    pos, uv, nrm = (t.detach().cpu().numpy()
                    for t in (mesh.positions, mesh.uvs, mesh.normals))
    with open(path, "w") as f:
        for p in pos:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in uv:
            f.write(f"vt {t[0]} {t[1]}\n")
        for n in nrm:
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for i in range(0, len(pos), 3):
            a, b, c = i + 1, i + 2, i + 3
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
