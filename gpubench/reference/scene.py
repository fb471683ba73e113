"""The reference's scene: render settings, meshes, materials, instances,
the vertex stage (``bake``, ``project``), the orbit camera and the lights.

Frozen copies of the port's ``config.py``, ``scene/mesh.py``,
``scene/materials.py``, ``scene/scene.py``, ``scene/camera.py`` (the orbit
camera's matrices) and ``scene/lights.py`` (the point light, the
directional light and the shadow camera's anchor), in one module, built
from a configuration file's description (``build``) rather than from the
port's objects. The reference app's constants are cited where they are
set.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import textures, transforms

# Metal's 4x MSAA rotated grid (offsets within a pixel); 1x: the center.
SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
}

# Material kinds (BlinnPhong.metal:40-58 no shadow, :60-97 with the shadow
# test, light.metal:27-29 emissive).
BLINN_PHONG = 0
BLINN_PHONG_SHADOW = 1
EMISSIVE = 2
MATERIAL_KINDS = {"blinn_phong": BLINN_PHONG,
                  "blinn_phong_shadow": BLINN_PHONG_SHADOW,
                  "emissive": EMISSIVE}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The render settings the reference reads (defaults: the reference
    app's, mtl_engine.mm:133, :582, :609, :612, mtl_engine.hpp:146)."""

    width: int = 800
    height: int = 600
    msaa: int = 4
    shadow_map_size: int = 1024
    clear_color: tuple = (41.0 / 255.0, 42.0 / 255.0, 48.0 / 255.0, 1.0)
    clear_depth: float = 1.0
    cull_backfaces: bool = True
    shadow_bias: float = 0.005
    shadow_factor: float = 0.5
    shadow_per_pixel: bool = True
    shading_per_pixel: bool = True
    fused_shade: bool = True
    tile_h: int = 8
    tile_w: int = 128
    shadow_tile_h: int = 64
    shadow_tile_w: int = 128
    span_cap: int = 8
    big_capacity: int = 256
    near_eps: float = 1e-6
    guard_band_px: float = 32768.0
    xyclip_capacity: int = 64

    @property
    def sample_positions(self):
        return SAMPLE_POSITIONS[self.msaa]


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Ortho shadow projection (mtl_engine.mm:645-646)."""

    left: float = -8.0
    right: float = 8.0
    bottom: float = -8.0
    top: float = 8.0
    near: float = 0.1
    far: float = 15.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    positions: torch.Tensor  # f32[N, 3]
    uvs: torch.Tensor        # f32[N, 2]
    normals: torch.Tensor    # f32[N, 3]

    @property
    def num_triangles(self):
        return self.positions.shape[0] // 3


def mesh_from_numpy(pos, uv, nrm, device="cpu") -> Mesh:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return Mesh(t(pos), t(uv), t(nrm))


def _mesh_from_rows(rows, device):
    a = np.asarray(rows, np.float32)
    return mesh_from_numpy(a[:, 0:3], a[:, 3:5], a[:, 5:8], device)


def cube(device="cpu") -> Mesh:
    """Unit cube, 36 vertices in MtlEngine::createCube's order
    (mtl_engine.mm:228-283): +Z, -Z, +Y, -Y, -X, +X faces."""
    faces = [  # (normal, the face's six (x, y, z, u, v) corners)
        ((0, 0, 1), [(-.5, -.5, .5, 0, 0), (.5, -.5, .5, 1, 0),
                     (.5, .5, .5, 1, 1), (.5, .5, .5, 1, 1),
                     (-.5, .5, .5, 0, 1), (-.5, -.5, .5, 0, 0)]),
        ((0, 0, -1), [(.5, -.5, -.5, 0, 0), (-.5, -.5, -.5, 1, 0),
                      (-.5, .5, -.5, 1, 1), (-.5, .5, -.5, 1, 1),
                      (.5, .5, -.5, 0, 1), (.5, -.5, -.5, 0, 0)]),
        ((0, 1, 0), [(-.5, .5, .5, 0, 0), (.5, .5, .5, 1, 0),
                     (.5, .5, -.5, 1, 1), (.5, .5, -.5, 1, 1),
                     (-.5, .5, -.5, 0, 1), (-.5, .5, .5, 0, 0)]),
        ((0, -1, 0), [(-.5, -.5, -.5, 0, 0), (.5, -.5, -.5, 1, 0),
                      (.5, -.5, .5, 1, 1), (.5, -.5, .5, 1, 1),
                      (-.5, -.5, .5, 0, 1), (-.5, -.5, -.5, 0, 0)]),
        ((-1, 0, 0), [(-.5, -.5, -.5, 0, 0), (-.5, -.5, .5, 1, 0),
                      (-.5, .5, .5, 1, 1), (-.5, .5, .5, 1, 1),
                      (-.5, .5, -.5, 0, 1), (-.5, -.5, -.5, 0, 0)]),
        ((1, 0, 0), [(.5, -.5, .5, 0, 0), (.5, -.5, -.5, 1, 0),
                     (.5, .5, -.5, 1, 1), (.5, .5, -.5, 1, 1),
                     (.5, .5, .5, 0, 1), (.5, -.5, .5, 0, 0)]),
    ]
    rows = [(*c, *n) for n, corners in faces for c in corners]
    return _mesh_from_rows(rows, device)


def plane(half_extent=1.5, device="cpu") -> Mesh:
    """Y-up plane, 2 triangles (MtlEngine::createPlane,
    mtl_engine.mm:285-296)."""
    e = half_extent
    rows = [(-e, 0, e, 0, 0, 0, 1, 0), (e, 0, e, 1, 0, 0, 1, 0),
            (e, 0, -e, 1, 1, 0, 1, 0), (e, 0, -e, 1, 1, 0, 1, 0),
            (-e, 0, -e, 0, 1, 0, 1, 0), (-e, 0, e, 0, 0, 0, 1, 0)]
    return _mesh_from_rows(rows, device)


@dataclasses.dataclass(frozen=True)
class Instance:
    mesh: Mesh
    model_matrix: torch.Tensor   # f32[4, 4]
    kind: int
    color: torch.Tensor          # f32[3]
    cast_shadow: bool = False
    use_displacement: bool = False
    normal_map_id: int = -1      # index into the frame's textures; -1: none
    texture_id: int = -1         # the base color's texture; -1: none


@dataclasses.dataclass(frozen=True)
class PackedGeometry:
    world: torch.Tensor
    uvs: torch.Tensor
    normals: torch.Tensor
    mat_kind: torch.Tensor
    mat_color: torch.Tensor
    tex_id: torch.Tensor
    normal_map_id: torch.Tensor
    cast_shadow: torch.Tensor


def bake(instances, displacement, device) -> PackedGeometry:
    """vertexBP (BlinnPhong.metal:14-38): object positions scaled by (1 +
    displacement) where the instance takes it, the model transform, normals
    by the model's upper-left 3x3 (not an inverse transpose), normalized."""
    one = torch.ones((), dtype=torch.float32, device=device)
    disp_scale = one + torch.as_tensor(displacement, dtype=torch.float32,
                                       device=device)
    parts = {k: [] for k in ("world", "uvs", "normals", "kind", "color",
                             "cast", "nmid", "texid")}
    for inst in instances:
        mesh = inst.mesh
        pos = mesh.positions * (disp_scale if inst.use_displacement else one)
        m = inst.model_matrix.to(device)
        parts["world"].append(transforms.transform_points(m, pos)[:, :3])
        parts["uvs"].append(mesh.uvs)
        parts["normals"].append(transforms.normalize(transforms.transform_dirs(
            transforms.upper_left_3x3(m), mesh.normals)))
        t = mesh.num_triangles
        parts["kind"].append(torch.full((t,), inst.kind, dtype=torch.int32,
                                        device=device))
        parts["color"].append(inst.color.to(device).expand(t, 3))
        parts["cast"].append(torch.full((t,), inst.cast_shadow,
                                        dtype=torch.bool, device=device))
        parts["nmid"].append(torch.full((t,), inst.normal_map_id,
                                        dtype=torch.int32, device=device))
        parts["texid"].append(torch.full((t,), inst.texture_id,
                                         dtype=torch.int32, device=device))
    kinds = torch.cat(parts["kind"])
    return PackedGeometry(
        world=torch.cat(parts["world"]), uvs=torch.cat(parts["uvs"]),
        normals=torch.cat(parts["normals"]), mat_kind=kinds,
        mat_color=torch.cat(parts["color"]),
        tex_id=torch.cat(parts["texid"]),
        normal_map_id=torch.cat(parts["nmid"]),
        cast_shadow=torch.cat(parts["cast"]))


def project(world_positions, view, proj):
    """clip = P @ V @ world (BlinnPhong.metal:27), P @ V formed first."""
    vp = transforms.matmul(proj, view).to(world_positions.device)
    return transforms.transform_points(vp, world_positions)


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


_PHI_EPS = 0.001   # Camera.cpp:19


@dataclasses.dataclass(frozen=True)
class OrbitCamera:
    """Camera.{hpp,cpp}: spherical coordinates around a target, a
    right-handed look-at and Metal's [0, 1] perspective."""

    radius: float = 2.0
    theta: float = 3.14
    phi: float = 1.57
    target: tuple = (0.0, 0.0, 0.0)
    fov_degrees: float = 45.0
    near: float = 0.01
    far: float = 100.0
    aspect: float = 1.0

    @property
    def position(self):
        phi = torch.clamp(_f32(self.phi), _PHI_EPS, math.pi - _PHI_EPS)
        theta = _f32(self.theta)
        return _f32(self.target) + _f32(self.radius) * torch.stack([
            torch.sin(phi) * torch.sin(theta), torch.cos(phi),
            torch.sin(phi) * torch.cos(theta)])

    def view_matrix(self):
        return transforms.look_at_rh(
            self.position, _f32(self.target),
            torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32))

    def projection_matrix(self):
        fov = _f32(self.fov_degrees) * (math.pi / 180.0)
        return transforms.perspective_rh(fov, self.aspect, self.near,
                                         self.far)


@dataclasses.dataclass(frozen=True)
class PointLight:
    position: tuple = (0.0, 2.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """BASELINE config 4's sun, at infinity: ``direction`` points FROM the
    light."""

    direction: tuple = (0.0, -1.0, -0.3)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class Lighting:
    light: object
    ambient_intensity: float = 0.1   # mtl_engine.mm:757
    shininess: float = 32.0          # mtl_engine.mm:758


def light_anchor_position(light, shadow_target, shadow: ShadowConfig):
    """Where the shadow pass's light view sits: a point light at its own
    position (mtl_engine.mm:668); a directional light's shadow camera along
    -direction from the target at mid-ortho-depth, so that casters near
    the target land inside the ortho volume's [near, far] (a frozen copy of
    the port's ``scene/lights.light_anchor_position``)."""
    if isinstance(light, DirectionalLight):
        d = transforms.normalize(_f32(light.direction))
        standoff = 0.5 * (shadow.near + shadow.far)
        return _f32(shadow_target) - d * standoff
    return _f32(light.position)


def _adaptive_up(forward):
    """The if-chain at mtl_engine.mm:672-683."""
    af = torch.abs(forward)
    if bool((af[1] < af[0]) & (af[1] < af[2])):
        return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
    if bool(af[0] < af[2]):
        return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32)
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)


def light_view_matrix(light_pos, look_target):
    """mtl_engine.mm:668-690: forward, adaptive up, right/up rebuilt."""
    light_pos, look_target = _f32(light_pos), _f32(look_target)
    forward = transforms.normalize(look_target - light_pos)
    right = transforms.normalize(transforms.cross(forward,
                                                  _adaptive_up(forward)))
    up = transforms.cross(right, forward)
    return transforms.look_at_rh(light_pos, look_target, up)


def light_projection_matrix(shadow: ShadowConfig):
    return transforms.ortho_rh(shadow.left, shadow.right, shadow.bottom,
                               shadow.top, shadow.near, shadow.far)


def model_matrix(desc):
    """translate @ scale of an instance description, then @ its
    ``rotate`` ({"angle": radians, "axis": [x, y, z]}) where it has one:
    the order of the port's ``engine/configs.config2_multi_mesh``."""
    m = transforms.matmul(transforms.translation(*desc.get(
        "translate", (0.0, 0.0, 0.0))), transforms.scale(*desc.get(
            "scale", (1.0, 1.0, 1.0))))
    if "rotate" in desc:
        r = desc["rotate"]
        m = transforms.matmul(m, transforms.rotation(r["angle"], r["axis"]))
    return m


def build(config, mesh_arrays, light_color=None, device="cpu"):
    """(instances, camera, lighting, RenderConfig, ShadowConfig,
    shadow_target) of a configuration file's description. ``mesh_arrays``:
    {instance index: (pos, uv, nrm) numpy} for meshes the benchmark made,
    an OBJ mesh's as the reference's reader read them back from its file
    (``harness.check.reference_arrays``); ``texture_chains`` makes the mip
    chains of its ``"textures"``;
    ``light_color``: the frame's light color where the light follows the
    audio (an emissive ``"color": "light"`` takes it too)."""
    render = RenderConfig(**config["render"])
    shadow = ShadowConfig(**config.get("shadow", {}))
    ld = config["light"]
    color = ld.get("color", (1.0, 1.0, 1.0)) if light_color is None \
        else light_color
    if ld["kind"] == "point":
        light = PointLight(tuple(ld["position"]), color,
                           ld.get("intensity", 1.0))
    elif ld["kind"] == "directional":
        light = DirectionalLight(tuple(ld["direction"]), color,
                                 ld.get("intensity", 1.0))
    else:
        raise ValueError(f"no cell takes a {ld['kind']!r} light")
    lighting = Lighting(light, config.get("ambient_intensity", 0.1),
                        config.get("shininess", 32.0))
    instances = []
    for i, d in enumerate(config["instances"]):
        kind = d["mesh"]["kind"]
        if kind == "cube":
            m = cube(device)
        elif kind == "plane":
            m = plane(device=device)
        else:
            m = mesh_from_numpy(*mesh_arrays[i], device=device)
        mat = d["material"]
        c = color if mat["color"] == "light" else mat["color"]
        instances.append(Instance(
            m, model_matrix(d), MATERIAL_KINDS[mat["kind"]],
            torch.as_tensor(c, dtype=torch.float32).reshape(3),
            d.get("cast_shadow", False), d.get("use_displacement", False),
            d.get("normal_map_id", -1), d.get("texture_id", -1)))
    camera = OrbitCamera(**config["camera"],
                         aspect=render.width / render.height)
    return (instances, camera, lighting, render, shadow,
            tuple(config.get("shadow_target", (0.0, 0.0, 0.0))))


def texture_chains(mesh_arrays, device="cpu"):
    """The frame's textures: the mip chain (``reference.textures.
    from_array``) of each base image the benchmark made, on ``device``."""
    return tuple(tuple(level.to(device) for level in textures.from_array(a))
                 for a in mesh_arrays.get("textures", ()))
