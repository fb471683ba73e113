"""Mesh data and procedural geometry builders.

Torch counterpart of ``metalrenderer_tpu.scene.mesh``: the reference's
hard-coded vertex arrays (mtl_engine.mm:228-283 cube, :285-296 plane) as
non-indexed triangle soups in struct-of-arrays form: positions [N,3],
uv [N,2], normal [N,3] with N = 3 * num_triangles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle-soup mesh (VertexData.hpp:6-11 minus the constant w=1)."""

    positions: torch.Tensor  # f32[N, 3]
    uvs: torch.Tensor        # f32[N, 2]
    normals: torch.Tensor    # f32[N, 3]

    @property
    def num_triangles(self):
        return self.positions.shape[0] // 3

    def to(self, device):
        return Mesh(self.positions.to(device), self.uvs.to(device),
                    self.normals.to(device))


def _mesh_from_list(rows, device="cpu"):
    """rows: list of (px,py,pz, u,v, nx,ny,nz)."""
    a = torch.from_numpy(np.asarray(rows, np.float32)).to(device)
    return Mesh(positions=a[:, 0:3].contiguous(), uvs=a[:, 3:5].contiguous(),
                normals=a[:, 5:8].contiguous())


def cube(device="cpu") -> Mesh:
    """Unit cube (side 1, centered), 36 vertices, CCW winding, per-face
    normals and UVs — exact vertex order of MtlEngine::createCube
    (mtl_engine.mm:228-283)."""
    f = [
        # Front face (+Z)
        (-0.5, -0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0),
        (0.5, -0.5, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0),
        (0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.0, 1.0),
        (0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.0, 1.0),
        (-0.5, 0.5, 0.5, 0.0, 1.0, 0.0, 0.0, 1.0),
        (-0.5, -0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0),
        # Back face (-Z)
        (0.5, -0.5, -0.5, 0.0, 0.0, 0.0, 0.0, -1.0),
        (-0.5, -0.5, -0.5, 1.0, 0.0, 0.0, 0.0, -1.0),
        (-0.5, 0.5, -0.5, 1.0, 1.0, 0.0, 0.0, -1.0),
        (-0.5, 0.5, -0.5, 1.0, 1.0, 0.0, 0.0, -1.0),
        (0.5, 0.5, -0.5, 0.0, 1.0, 0.0, 0.0, -1.0),
        (0.5, -0.5, -0.5, 0.0, 0.0, 0.0, 0.0, -1.0),
        # Top face (+Y)
        (-0.5, 0.5, 0.5, 0.0, 0.0, 0.0, 1.0, 0.0),
        (0.5, 0.5, 0.5, 1.0, 0.0, 0.0, 1.0, 0.0),
        (0.5, 0.5, -0.5, 1.0, 1.0, 0.0, 1.0, 0.0),
        (0.5, 0.5, -0.5, 1.0, 1.0, 0.0, 1.0, 0.0),
        (-0.5, 0.5, -0.5, 0.0, 1.0, 0.0, 1.0, 0.0),
        (-0.5, 0.5, 0.5, 0.0, 0.0, 0.0, 1.0, 0.0),
        # Bottom face (-Y)
        (-0.5, -0.5, -0.5, 0.0, 0.0, 0.0, -1.0, 0.0),
        (0.5, -0.5, -0.5, 1.0, 0.0, 0.0, -1.0, 0.0),
        (0.5, -0.5, 0.5, 1.0, 1.0, 0.0, -1.0, 0.0),
        (0.5, -0.5, 0.5, 1.0, 1.0, 0.0, -1.0, 0.0),
        (-0.5, -0.5, 0.5, 0.0, 1.0, 0.0, -1.0, 0.0),
        (-0.5, -0.5, -0.5, 0.0, 0.0, 0.0, -1.0, 0.0),
        # Left face (-X)
        (-0.5, -0.5, -0.5, 0.0, 0.0, -1.0, 0.0, 0.0),
        (-0.5, -0.5, 0.5, 1.0, 0.0, -1.0, 0.0, 0.0),
        (-0.5, 0.5, 0.5, 1.0, 1.0, -1.0, 0.0, 0.0),
        (-0.5, 0.5, 0.5, 1.0, 1.0, -1.0, 0.0, 0.0),
        (-0.5, 0.5, -0.5, 0.0, 1.0, -1.0, 0.0, 0.0),
        (-0.5, -0.5, -0.5, 0.0, 0.0, -1.0, 0.0, 0.0),
        # Right face (+X)
        (0.5, -0.5, 0.5, 0.0, 0.0, 1.0, 0.0, 0.0),
        (0.5, -0.5, -0.5, 1.0, 0.0, 1.0, 0.0, 0.0),
        (0.5, 0.5, -0.5, 1.0, 1.0, 1.0, 0.0, 0.0),
        (0.5, 0.5, -0.5, 1.0, 1.0, 1.0, 0.0, 0.0),
        (0.5, 0.5, 0.5, 0.0, 1.0, 1.0, 0.0, 0.0),
        (0.5, -0.5, 0.5, 0.0, 0.0, 1.0, 0.0, 0.0),
    ]
    return _mesh_from_list(f, device)


def plane(half_extent: float = 1.5, device="cpu") -> Mesh:
    """Y-up plane, 2 triangles — MtlEngine::createPlane (mtl_engine.mm:285-296)."""
    e = half_extent
    rows = [
        (-e, 0.0, e, 0.0, 0.0, 0.0, 1.0, 0.0),
        (e, 0.0, e, 1.0, 0.0, 0.0, 1.0, 0.0),
        (e, 0.0, -e, 1.0, 1.0, 0.0, 1.0, 0.0),
        (e, 0.0, -e, 1.0, 1.0, 0.0, 1.0, 0.0),
        (-e, 0.0, -e, 0.0, 1.0, 0.0, 1.0, 0.0),
        (-e, 0.0, e, 0.0, 0.0, 0.0, 1.0, 0.0),
    ]
    return _mesh_from_list(rows, device)
