"""Mesh data and procedural geometry builders.

Torch counterpart of ``metalrenderer_tpu.scene.mesh``: the reference's
hard-coded vertex arrays (mtl_engine.mm:228-283 cube, :285-296 plane,
:352-373 legacy triangle/square) and a UV sphere as non-indexed triangle
soups in struct-of-arrays form: positions [N,3], uv [N,2], normal [N,3]
with N = 3 * num_triangles. Every builder makes its vertices with numpy in
float32, as the JAX builders do, so the meshes are bit-equal to theirs.
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
    def num_vertices(self):
        return self.positions.shape[0]

    @property
    def num_triangles(self):
        return self.positions.shape[0] // 3

    def to(self, device):
        return Mesh(self.positions.to(device), self.uvs.to(device),
                    self.normals.to(device))


def from_numpy(pos, uv, nrm, device="cpu") -> Mesh:
    """A mesh on ``device`` from numpy positions [N,3], uvs [N,2] and
    normals [N,3], taken as float32."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return Mesh(positions=t(pos), uvs=t(uv), normals=t(nrm))


def _mesh_from_list(rows, device="cpu"):
    """rows: list of (px,py,pz, u,v, nx,ny,nz)."""
    a = np.asarray(rows, np.float32)
    return from_numpy(a[:, 0:3], a[:, 3:5], a[:, 5:8], device)


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


def triangle(device="cpu") -> Mesh:
    """Legacy tutorial triangle (mtl_engine.mm:352-360)."""
    rows = [
        (-0.5, -0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
        (0.5, -0.5, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
        (0.0, 0.5, 0.0, 0.5, 1.0, 0.0, 0.0, 1.0),
    ]
    return _mesh_from_list(rows, device)


def square(device="cpu") -> Mesh:
    """Legacy tutorial square (mtl_engine.mm:362-373)."""
    rows = [
        (-0.5, -0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0),
        (-0.5, 0.5, 0.5, 0.0, 1.0, 0.0, 0.0, 1.0),
        (0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.0, 1.0),
        (-0.5, -0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0),
        (0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.0, 1.0),
        (0.5, -0.5, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0),
    ]
    return _mesh_from_list(rows, device)


def uv_sphere(stacks: int = 16, slices: int = 32, radius: float = 0.5,
              device="cpu") -> Mesh:
    """UV sphere triangle soup with smooth normals and CCW winding (viewed
    from outside), two triangles per quad, none at the poles' degenerate
    quads (BASELINE config 2's spheres)."""
    verts = []
    for i in range(stacks):
        phi0 = np.pi * i / stacks
        phi1 = np.pi * (i + 1) / stacks
        for j in range(slices):
            th0 = 2 * np.pi * j / slices
            th1 = 2 * np.pi * (j + 1) / slices

            def pt(phi, th):
                n = np.array([np.sin(phi) * np.cos(th), np.cos(phi),
                              np.sin(phi) * np.sin(th)], np.float32)
                uv = np.array([th / (2 * np.pi), 1.0 - phi / np.pi],
                              np.float32)
                return n * radius, uv, n

            p00, p01 = pt(phi0, th0), pt(phi0, th1)
            p10, p11 = pt(phi1, th0), pt(phi1, th1)
            if i > 0:
                verts += [p00, p11, p01]
            if i < stacks - 1:
                verts += [p00, p10, p11]
    return from_numpy(*(np.stack([v[k] for v in verts])
                              for k in range(3)), device)


def concatenate(meshes) -> Mesh:
    """One soup of the meshes' triangles, in order (on their device)."""
    return Mesh(positions=torch.cat([m.positions for m in meshes]),
                uvs=torch.cat([m.uvs for m in meshes]),
                normals=torch.cat([m.normals for m in meshes]))
