"""Scene graph: instances + bake to packed triangle buffers.

Torch counterpart of ``metalrenderer_tpu.scene.scene``. The reference
encodes three draw calls per frame with per-draw uniform buffers
(encodeMainCube/encodeLightCube/encodePlane, mtl_engine.mm:821-877); here a
scene is a tuple of instances and ``bake`` runs the world-space part of the
vertex stage for all of them into flat triangle buffers on the scene's
device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..math import transforms
from .materials import Material
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Instance:
    """One drawable: mesh + model transform + material + flags.

    ``use_displacement`` mirrors the audio vertex displacement input of
    vertexBP (BlinnPhong.metal:23: position.xyz * (1 + displacement)).
    """

    mesh: Mesh = None
    model_matrix: torch.Tensor = None       # f32[4,4]
    material: Material = None
    cast_shadow: bool = False
    use_displacement: bool = False

    def to(self, device):
        return dataclasses.replace(
            self, mesh=self.mesh.to(device),
            model_matrix=self.model_matrix.to(device),
            material=self.material.to(device))


@dataclasses.dataclass(frozen=True)
class Scene:
    instances: tuple = ()
    # Texture mip chains: a tuple of tuples of f32[H, W, 4] levels, indexed
    # by Material.texture_id / normal_map_id. A textured scene takes the
    # split path.
    textures: tuple = ()

    @property
    def num_triangles(self):
        return sum(i.mesh.num_triangles for i in self.instances)

    def to(self, device):
        return Scene(instances=tuple(i.to(device) for i in self.instances),
                     textures=tuple(tuple(level.to(device) for level in mips)
                                    for mips in self.textures))


@dataclasses.dataclass(frozen=True)
class PackedGeometry:
    """Flat world-space triangle buffers after the vertex stage."""

    world: torch.Tensor      # f32[V, 3] world-space positions
    uvs: torch.Tensor        # f32[V, 2]
    normals: torch.Tensor    # f32[V, 3] world-space, normalized per vertex
    mat_kind: torch.Tensor   # i32[T] material kind per triangle
    mat_color: torch.Tensor  # f32[T, 3]
    tex_id: torch.Tensor     # i32[T] texture index (-1 = none)
    normal_map_id: torch.Tensor  # i32[T] normal-map index (-1 = none)
    cast_shadow: torch.Tensor  # bool[T]

    @property
    def num_triangles(self):
        return self.mat_kind.shape[0]


def bake(scene: Scene, displacement=0.0) -> PackedGeometry:
    """Mirrors vertexBP (BlinnPhong.metal:14-38): audio displacement scaling
    of object-space positions, model transform, and normal transform by the
    model matrix's upper-left 3x3 (NOT an inverse-transpose;
    BlinnPhong.metal:21) with per-vertex normalization."""
    device = scene.instances[0].model_matrix.device
    one = torch.ones((), dtype=torch.float32, device=device)
    disp_scale = one + torch.as_tensor(displacement, dtype=torch.float32,
                                       device=device)
    worlds, uvs, nrms = [], [], []
    kinds, colors, texids, nmids, casts = [], [], [], [], []
    for inst in scene.instances:
        mesh = inst.mesh
        pos = mesh.positions * (disp_scale if inst.use_displacement else one)
        m = inst.model_matrix
        world = transforms.transform_points(m, pos)[:, :3]
        nmat = transforms.upper_left_3x3(m)
        nrm = transforms.normalize(transforms.transform_dirs(nmat, mesh.normals))
        t = mesh.num_triangles
        worlds.append(world)
        uvs.append(mesh.uvs)
        nrms.append(nrm)

        def full(v, dtype):
            return torch.full((t,), v, dtype=dtype, device=device)
        kinds.append(full(inst.material.kind, torch.int32))
        colors.append(inst.material.color.expand(t, 3))
        texids.append(full(inst.material.texture_id, torch.int32))
        nmids.append(full(inst.material.normal_map_id, torch.int32))
        casts.append(full(inst.cast_shadow, torch.bool))
    return PackedGeometry(
        world=torch.cat(worlds), uvs=torch.cat(uvs), normals=torch.cat(nrms),
        mat_kind=torch.cat(kinds), mat_color=torch.cat(colors),
        tex_id=torch.cat(texids), normal_map_id=torch.cat(nmids),
        cast_shadow=torch.cat(casts),
    )


def project(world_positions, view, proj):
    """Camera part of the vertex stage: clip = P @ V @ world
    (BlinnPhong.metal:27). ``view``/``proj`` may live on the CPU; the product
    is formed there and moved to the positions' device."""
    vp = transforms.matmul(proj, view).to(world_positions.device)
    return transforms.transform_points(vp, world_positions)
