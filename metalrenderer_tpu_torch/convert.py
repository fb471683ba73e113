"""Carry the JAX package's objects across to the port.

Scenes, meshes, model matrices, materials, cameras and lighting of
``metalrenderer_tpu`` (or anything with the same attributes) become the
port's objects on a given device, leaf by leaf through numpy, so both
packages can render exactly the same inputs. Intermediate products
(``TriangleSetup``, pass geometry) convert the same way, so a test can feed
one kernel's inputs to both packages, and so do the audio pipeline's
carried states, so a stream begun in one package continues in the other.
Nothing here imports jax: the objects
are read by attribute and their arrays with ``numpy.asarray``.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .audio.analyzer import AnalyzerState
from .audio.mapping import VisualParams, VisualState
from .math import transforms
from .raster.geometry import TriangleSetup
from .raster.setup_cuda import PassGeometry
from .raster.shade import GBuffer, ShadowContext
from .scene.camera import OrbitCamera, PoseCamera
from .scene.lights import DirectionalLight, Lighting, PointLight
from .scene.materials import Material
from .scene.mesh import Mesh
from .scene.scene import Instance, Scene


def tensor(x, device="cpu"):
    """An array-like as a torch tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(np.asarray(x))).to(device)


def _f32(x, device="cpu"):
    return tensor(np.asarray(x, np.float32), device)


def _floats(x):
    a = np.asarray(x, np.float32)
    return float(a) if a.ndim == 0 else tuple(float(v) for v in a)


def mesh_from_jax(m, device="cpu") -> Mesh:
    return Mesh(positions=_f32(m.positions, device), uvs=_f32(m.uvs, device),
                normals=_f32(m.normals, device))


def material_from_jax(mat, device="cpu") -> Material:
    return Material(color=_f32(mat.color, device), kind=int(mat.kind),
                    texture_id=int(mat.texture_id),
                    normal_map_id=int(mat.normal_map_id))


def scene_from_jax(scene, device="cpu") -> Scene:
    """Instances, and textures as a tuple of mip tuples."""
    return Scene(
        instances=tuple(
            Instance(mesh=mesh_from_jax(i.mesh, device),
                     model_matrix=_f32(i.model_matrix, device),
                     material=material_from_jax(i.material, device),
                     cast_shadow=bool(i.cast_shadow),
                     use_displacement=bool(i.use_displacement))
            for i in scene.instances),
        textures=tuple(tuple(_f32(level, device) for level in mips)
                       for mips in scene.textures))


def camera_from_jax(cam) -> OrbitCamera:
    """An orbit camera's parameters (f32 values, kept exactly)."""
    return OrbitCamera(
        radius=_floats(cam.radius), theta=_floats(cam.theta),
        phi=_floats(cam.phi), target=_floats(cam.target),
        fov_degrees=_floats(cam.fov_degrees), near=_floats(cam.near),
        far=_floats(cam.far), aspect=_floats(cam.aspect))


def cameras_from_jax(cams) -> list:
    """A stacked orbit-camera pytree (every leaf with a leading frame axis
    F, as the JAX ``render_batch(cameras=...)`` takes) as F port cameras.
    A field given as a tuple (``target=(0.0, 0.0, 0.0)``) is a tuple of
    stacked leaves there."""
    def frame(x, i):
        if isinstance(x, (tuple, list)):
            return tuple(np.asarray(e, np.float32)[i] for e in x)
        return np.asarray(x, np.float32)[i]

    fields = ("radius", "theta", "phi", "target", "fov_degrees", "near",
              "far", "aspect")
    n = np.asarray(cams.theta).shape[0]
    return [camera_from_jax(types.SimpleNamespace(
        **{f: frame(getattr(cams, f), i) for f in fields}))
        for i in range(n)]


_POSE_FIELDS = ("position", "orientation", "fov_degrees", "near", "far",
                "aspect")


def pose_camera_from_jax(cam) -> PoseCamera:
    """A free camera's pose and lens, as f32 CPU tensors (kept exactly)."""
    return PoseCamera(**{f: _f32(getattr(cam, f)) for f in _POSE_FIELDS})


def pose_cameras_from_jax(cams) -> list:
    """A stacked PoseCamera pytree (every leaf with a leading frame axis F,
    as the JAX ``render_camera_path`` slerps them) as F port cameras."""
    leaves = {f: np.asarray(getattr(cams, f), np.float32)
              for f in _POSE_FIELDS}
    n = leaves["position"].shape[0]
    return [pose_camera_from_jax(types.SimpleNamespace(
        **{f: a[i] for f, a in leaves.items()})) for i in range(n)]


def lighting_from_jax(lighting) -> Lighting:
    """A point light (it has a ``position``) or a directional light."""
    light = lighting.light
    if hasattr(light, "position"):
        light = PointLight(position=_floats(light.position),
                           color=_floats(light.color),
                           intensity=_floats(light.intensity))
    else:
        light = DirectionalLight(direction=_floats(light.direction),
                                 color=_floats(light.color),
                                 intensity=_floats(light.intensity))
    return Lighting(
        light=light,
        ambient_intensity=_floats(lighting.ambient_intensity),
        shininess=_floats(lighting.shininess))


def setup_from_jax(setup, device="cpu") -> TriangleSetup:
    return TriangleSetup(**{
        f: tensor(getattr(setup, f), device)
        for f in ("valid", "screen", "z", "inv_w", "edge", "top_left",
                  "inv_area", "aabb")})


def pass_geometry_from_jax(pg, device="cpu") -> PassGeometry:
    return PassGeometry(**{
        f: tensor(getattr(pg, f), device)
        for f in ("vattrs", "mat_kind", "mat_color", "tex_id",
                  "normal_map_id")})


def gbuffer_from_jax(gbuf, device="cpu") -> GBuffer:
    """A JAX ``shade.GBuffer`` (the brute-force reference's G-buffer)."""
    return GBuffer(**{
        f: tensor(getattr(gbuf, f), device)
        for f in ("world", "normal", "uv", "depth", "mat_kind", "mat_color",
                  "tex_id", "normal_map_id", "covered")})


def shadow_context_from_jax(ctx, device="cpu") -> ShadowContext:
    """A JAX ``shade.ShadowContext``: its depth map, and its light view and
    projection as the port's one matrix ``light_m = light_proj @
    light_view`` (``transforms.matmul``: a float32 sum of separately
    rounded products, as the port's pipeline forms it)."""
    light_m = transforms.matmul(_f32(ctx.light_proj), _f32(ctx.light_view))
    return ShadowContext(depth_map=_f32(ctx.depth_map, device),
                         light_m=light_m.to(device))


def analyzer_state_from_jax(state) -> AnalyzerState:
    """The analyzer's cross-chunk carry (the port keeps it on the host)."""
    return AnalyzerState(**{
        f: tensor(getattr(state, f))
        for f in ("rolling", "rolling_idx", "rolling_count", "rolling_sum",
                  "smoothed_bass", "smoothed_mid", "smoothed_treble")})


def visual_state_from_jax(state) -> VisualState:
    """The brightness envelope's carry (on the host)."""
    return VisualState(brightness_envelope=_f32(state.brightness_envelope))


def visual_params_from_jax(params, device="cpu") -> VisualParams:
    """One frame's or a whole track's scene parameters."""
    return VisualParams(
        light_color=_f32(params.light_color, device),
        light_intensity=_f32(params.light_intensity, device),
        displacement=_f32(params.displacement, device))
