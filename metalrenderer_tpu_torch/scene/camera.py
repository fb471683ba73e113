"""Orbit camera (torch counterpart of ``metalrenderer_tpu.scene.camera``).

``OrbitCamera`` is Camera.{hpp,cpp}: spherical coordinates
(radius/theta/phi) around a target, phi clamped near the poles
(Camera.cpp:17-21) and a right-handed look-at view matrix
(Camera.cpp:52-71). The camera is host-side state: its matrices are small
f32 CPU tensors, computed once per frame and moved to the render device by
the pipeline, so the CPU and GPU renders see the same bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..math import transforms

_PHI_EPS = 0.001           # Camera.cpp:19


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class OrbitCamera:
    # Defaults from Camera.cpp:3-8.
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
        """Spherical -> Cartesian (Camera.cpp:22-27). f32[3] on the CPU."""
        phi = torch.clamp(_f32(self.phi), _PHI_EPS, math.pi - _PHI_EPS)
        theta = _f32(self.theta)
        return _f32(self.target) + _f32(self.radius) * torch.stack([
            torch.sin(phi) * torch.sin(theta),
            torch.cos(phi),
            torch.sin(phi) * torch.cos(theta),
        ])

    @property
    def up(self):
        return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)  # Camera.cpp:30

    def view_matrix(self):
        return transforms.look_at_rh(self.position, _f32(self.target), self.up)

    def projection_matrix(self):
        """Metal z in [0,1] RH perspective (mtl_engine.hpp:86-95, used at
        mtl_engine.mm:661-662 with fov in degrees converted to radians)."""
        fov = _f32(self.fov_degrees) * (math.pi / 180.0)
        return transforms.perspective_rh(fov, self.aspect, self.near, self.far)
