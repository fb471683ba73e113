"""BASELINE configurations built from the port's own primitives.

Each is a copy of ``benchmarks/configs.py``'s builder of the same number
(that module imports JAX), with the same arguments and the same draws from
the same seeds, plus ``device``.

``config1_textured_cube`` is its config 1: a cube with a 256^2
checkerboard texture under the default point light, 512x512 with 4x MSAA;
no shadow pass (nothing receives shadows). It renders through the split
path (K3 and K9; K5 in a batch).

``config2_multi_mesh`` is its config 2: ``n_objects`` cubes and UV spheres
(12 x 24) with seeded per-object transforms and four palette colors on a
10x floor, untextured, under the default point light, at 1920x1080 with
4x MSAA. Nothing receives shadows, so no shadow pass: the fused path, K2
with no shadow map (K6 in a batch).

``config3_high_poly`` is its config 3: a ~100k-triangle sphere saved as an
OBJ file and loaded back through ``io/obj.py`` (the native parser where it
builds), with a 512^2 checkerboard and its mips, at 1920x1080 with one
sample and span cap 4: the split path, K3 and K9 (K5 in a batch).

``config4_shadow_normal_map`` is its config 4: a Blinn-Phong
cube with a 256^2 normal map (a sinusoidal height field, a 9-level mip
chain) casting a shadow onto a shadow-receiving floor, under a
shadow-mapped directional light (the sun), at 1920x1080 with 4x MSAA and a
1024^2 shadow map. It renders with ``render_frame``'s default
``shadow_target`` (0, 0, 0), through the split path (K1, K3, K7, K9).

``config5_animated_high_poly`` is its config 5: a 1M-triangle sphere with
audio displacement at 3840x2160, one sample, span cap 4: the fused path,
K2 with no shadow map (K6 over a batch of displacements).
"""
from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np
import torch

from ..config import RenderConfig
from ..io import obj
from ..io.textures import checkerboard, from_array
from ..math import transforms
from ..scene import mesh
from ..scene.camera import OrbitCamera
from ..scene.lights import DirectionalLight, Lighting
from ..scene.materials import BLINN_PHONG, BLINN_PHONG_SHADOW, Material
from ..scene.scene import Instance, Scene

# Where config 3's OBJ file is written when no ``cache_dir`` is given: the
# package's gitignored build directory.
ASSET_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build" / "assets"


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def bumpy_normal_map(n=256):
    """Tangent-space normals of h = 0.15 sin(12 pi x) sin(12 pi y), packed
    to [0, 1] RGBA, as a mip chain."""
    y, x = np.mgrid[0:n, 0:n] / n
    h = 0.15 * np.sin(12 * np.pi * x) * np.sin(12 * np.pi * y)
    dhdx = np.gradient(h, axis=1) * n
    dhdy = np.gradient(h, axis=0) * n
    nm = np.stack([-dhdx, -dhdy, np.ones_like(h)], -1)
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    nm01 = ((nm + 1) / 2).astype(np.float32)
    return from_array(
        np.concatenate([nm01, np.ones((n, n, 1), np.float32)], -1),
        generate_mips=True)


def config1_textured_cube(width=512, height=512, device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 1."""
    tex = checkerboard(size=256, squares=8, color_a=(0.9, 0.9, 0.85),
                       color_b=(0.25, 0.55, 0.2))
    scene = Scene(
        instances=(Instance(
            mesh=mesh.cube(), model_matrix=transforms.translation(0, 0, 0),
            material=Material(color=torch.ones(3), kind=BLINN_PHONG,
                              texture_id=0)),),
        textures=(tex,))
    camera = OrbitCamera(radius=2.5, theta=2.5, phi=1.2,
                         aspect=width / height)
    cfg = RenderConfig(width=width, height=height, msaa=4,
                       shadow_map_size=64)
    return scene.to(device), camera, Lighting.default(), cfg


def config2_multi_mesh(n_objects=24, width=1920, height=1080, seed=0,
                       device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 2.
    Object i is a cube (i even) or a sphere, at a position, scale, angle
    and axis drawn in that order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cube_mesh = mesh.cube()
    sphere_mesh = mesh.uv_sphere(stacks=12, slices=24)
    palette = [(1.0, 0.5, 0.31), (0.3, 0.6, 0.9), (0.8, 0.8, 0.3),
               (0.6, 0.3, 0.7)]
    instances = []
    for i in range(n_objects):
        pos = rng.uniform(-4, 4, 3) * np.array([1, 0.4, 1]) + [0, 0.5, 0]
        s = rng.uniform(0.3, 0.9)
        angle = rng.uniform(0, np.pi)
        axis = rng.uniform(-1, 1, 3)
        m = transforms.matmul(
            transforms.matmul(transforms.translation(*pos),
                              transforms.scale(s, s, s)),
            transforms.rotation(angle, axis))
        instances.append(Instance(
            mesh=cube_mesh if i % 2 == 0 else sphere_mesh, model_matrix=m,
            material=Material(color=_f32(palette[i % 4]), kind=BLINN_PHONG)))
    instances.append(Instance(
        mesh=mesh.plane(), model_matrix=transforms.matmul(
            transforms.translation(0.0, -1.0, 0.0),
            transforms.scale(10.0, 1.0, 10.0)),
        material=Material(color=_f32([0.5, 0.7, 0.5]), kind=BLINN_PHONG)))
    camera = OrbitCamera(radius=9.0, theta=2.4, phi=1.1,
                         aspect=width / height)
    cfg = RenderConfig(width=width, height=height, msaa=4,
                       shadow_map_size=64)
    return (Scene(instances=tuple(instances)).to(device), camera,
            Lighting.default(), cfg)


def _dense_sphere_mesh(target_tris, device="cpu"):
    """A high-poly sphere of radius 0.5 standing in for an OBJ asset
    (about ``target_tris`` triangles; the poles' quads degenerate), built
    vectorized with numpy in float32."""
    stacks = max(8, int(np.sqrt(target_tris / 4)))
    slices = 2 * stacks
    phi = np.linspace(0, np.pi, stacks + 1)
    th = np.linspace(0, 2 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, th, indexing="ij")
    pts = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), 1 - pp / np.pi], -1).astype(np.float32)

    def quad_corners(a):  # [stacks+1, slices+1, C] -> two tris per quad
        c00 = a[:-1, :-1]
        c01 = a[:-1, 1:]
        c10 = a[1:, :-1]
        c11 = a[1:, 1:]
        t1 = np.stack([c00, c11, c01], axis=2)
        t2 = np.stack([c00, c10, c11], axis=2)
        return np.concatenate([t1, t2], axis=2).reshape(-1, a.shape[-1])

    pos = quad_corners(pts)
    # Unit sphere: the normal is the position.
    return mesh.from_numpy(pos * 0.5, quad_corners(uv), pos, device)


def obj_asset_path(target_tris, cache_dir=None) -> pathlib.Path:
    """Config 3's OBJ file: ``_dense_sphere_mesh(target_tris)`` saved once
    under ``cache_dir`` (default ``ASSET_DIR``), keyed by the builder's
    bytecode, so an edited builder never reads a stale file."""
    cache = pathlib.Path(cache_dir) if cache_dir is not None else ASSET_DIR
    cache.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha1(_dense_sphere_mesh.__code__.co_code).hexdigest()[:8]
    path = cache / f"sphere_{target_tris}_{tag}.obj"
    if not path.exists():
        tmp = path.with_suffix(f".obj.tmp{os.getpid()}")
        obj.save_obj(tmp, _dense_sphere_mesh(target_tris))
        tmp.replace(path)
    return path


def config3_high_poly(target_tris=100_000, width=1920, height=1080,
                      cache_dir=None, device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 3,
    its mesh loaded from ``obj_asset_path(target_tris, cache_dir)``."""
    tex = checkerboard(size=512, squares=16)
    scene = Scene(
        instances=(Instance(
            mesh=obj.load_obj(obj_asset_path(target_tris, cache_dir)),
            model_matrix=transforms.translation(0, 0, 0),
            material=Material(color=torch.ones(3), kind=BLINN_PHONG,
                              texture_id=0)),),
        textures=(tex,))
    camera = OrbitCamera(radius=2.0, theta=2.5, phi=1.3,
                         aspect=width / height)
    # Span cap 4 halves the binning entries; the ~14 px^2 triangles span
    # more than 2x2 tiles only at grazing silhouettes (the big list).
    cfg = RenderConfig(width=width, height=height, msaa=1,
                       shadow_map_size=64, span_cap=4)
    return scene.to(device), camera, Lighting.default(), cfg


def config4_shadow_normal_map(width=1920, height=1080, device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 4."""
    scene = Scene(
        instances=(
            Instance(mesh=mesh.cube(),
                     model_matrix=transforms.translation(0.0, 0.0, -1.0),
                     material=Material(color=_f32([1.0, 0.5, 0.31]),
                                       kind=BLINN_PHONG, normal_map_id=0),
                     cast_shadow=True),
            Instance(mesh=mesh.plane(),
                     model_matrix=transforms.matmul(
                         transforms.translation(0.0, -1.0, 0.0),
                         transforms.scale(10.0, 1.0, 10.0)),
                     material=Material(color=_f32([0.5, 0.7, 0.5]),
                                       kind=BLINN_PHONG_SHADOW)),
        ),
        textures=(bumpy_normal_map(),))
    camera = OrbitCamera(radius=5.0, theta=2.5, phi=1.2,
                         aspect=width / height)
    cfg = RenderConfig(width=width, height=height, msaa=4,
                       shadow_map_size=1024)
    lighting = Lighting(light=DirectionalLight(
        direction=(-0.45, -1.0, -0.35), color=(1.0, 1.0, 1.0),
        intensity=1.0))
    return scene.to(device), camera, lighting, cfg


def config5_animated_high_poly(target_tris=1_000_000, width=3840,
                               height=2160, device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 5:
    render it with a ``displacement`` per frame."""
    scene = Scene(
        instances=(Instance(
            mesh=_dense_sphere_mesh(target_tris),
            model_matrix=transforms.translation(0, 0, 0),
            material=Material(color=_f32([0.8, 0.4, 0.3]), kind=BLINN_PHONG),
            use_displacement=True),))
    camera = OrbitCamera(radius=2.0, theta=2.5, phi=1.3,
                         aspect=width / height)
    cfg = RenderConfig(width=width, height=height, msaa=1,
                       shadow_map_size=64, span_cap=4)
    return scene.to(device), camera, Lighting.default(), cfg
