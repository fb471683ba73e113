"""BASELINE configurations built from the port's own primitives.

``config1_textured_cube`` is ``benchmarks/configs.py``'s config 1 (a copy:
that module imports JAX): a cube with a 256^2 checkerboard texture under
the default point light, 512x512 with 4x MSAA; no shadow pass (nothing
receives shadows). It renders through the split path (K3 and K9; K5 in a
batch).

``config4_shadow_normal_map`` is its config 4 (a copy too): a Blinn-Phong
cube with a 256^2 normal map (a sinusoidal height field, a 9-level mip
chain) casting a shadow onto a shadow-receiving floor, under a
shadow-mapped directional light (the sun), at 1920x1080 with 4x MSAA and a
1024^2 shadow map. It renders with ``render_frame``'s default
``shadow_target`` (0, 0, 0), through the split path (K1, K3, K7, K9).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..io.textures import checkerboard, from_array
from ..math import transforms
from ..scene import mesh
from ..scene.camera import OrbitCamera
from ..scene.lights import DirectionalLight, Lighting
from ..scene.materials import BLINN_PHONG, BLINN_PHONG_SHADOW, Material
from ..scene.scene import Instance, Scene


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


def config4_shadow_normal_map(width=1920, height=1080, device="cuda"):
    """(scene on ``device``, camera, lighting, config) of BASELINE config 4."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    scene = Scene(
        instances=(
            Instance(mesh=mesh.cube(),
                     model_matrix=transforms.translation(0.0, 0.0, -1.0),
                     material=Material(color=f32([1.0, 0.5, 0.31]),
                                       kind=BLINN_PHONG, normal_map_id=0),
                     cast_shadow=True),
            Instance(mesh=mesh.plane(),
                     model_matrix=transforms.matmul(
                         transforms.translation(0.0, -1.0, 0.0),
                         transforms.scale(10.0, 1.0, 10.0)),
                     material=Material(color=f32([0.5, 0.7, 0.5]),
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
