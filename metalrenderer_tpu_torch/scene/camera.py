"""Cameras (torch counterpart of ``metalrenderer_tpu.scene.camera``).

``OrbitCamera`` is Camera.{hpp,cpp}: spherical coordinates
(radius/theta/phi) around a target, phi clamped near the poles
(Camera.cpp:17-21), mouse-drag rotation (Camera.cpp:33-38), scroll dolly
with a minimum radius (Camera.cpp:41-46) and a right-handed look-at view
matrix (Camera.cpp:52-71). Updates return new cameras.

``PoseCamera`` is a free camera posed by a position and a unit quaternion
(camera-to-world, ``math.quaternion``). Poses interpolate by slerp, which is
what camera flythroughs (``engine.renderer.render_camera_path``) are made
of.

Cameras are host-side state: their matrices are small f32 CPU tensors,
computed once per frame and moved to the render device by the pipeline, so
the CPU and GPU renders see the same bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..math import quaternion, transforms

_PHI_EPS = 0.001           # Camera.cpp:19
_MOUSE_SENSITIVITY = 0.005  # Camera.cpp:6
_MOVEMENT_SPEED = 0.2       # Camera.cpp:6
_MIN_RADIUS = 0.5           # Camera.cpp:44


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _add(a, b):
    """``a + b`` as the JAX package computes it with x64 off: a Python float
    adds in float64, a tensor in float32 (``b`` rounded to f32 first)."""
    return a + _f32(b) if isinstance(a, torch.Tensor) else a + b


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

    # --- interaction (pure updates) ---------------------------------------
    # The JAX package's dtypes are kept: theta stays whatever it was (a
    # Python float is added to in float64), while phi and radius come out of
    # jnp.clip / jnp.maximum as f32 (here 0-d f32 tensors), the first update
    # rounding the float64 difference, later ones subtracting in f32.
    def process_mouse_movement(self, x_offset, y_offset):
        """Camera.cpp:33-38: theta += dx*s, phi -= dy*s*0.5."""
        phi = _f32(_add(self.phi, -(y_offset * _MOUSE_SENSITIVITY * 0.5)))
        return dataclasses.replace(
            self, theta=_add(self.theta, x_offset * _MOUSE_SENSITIVITY),
            phi=torch.clamp(phi, _PHI_EPS, math.pi - _PHI_EPS))

    def process_mouse_scroll(self, y_offset):
        """Camera.cpp:41-46: dolly with min radius 0.5."""
        radius = _f32(_add(self.radius, -(y_offset * _MOVEMENT_SPEED)))
        return dataclasses.replace(
            self, radius=torch.clamp_min(radius, _MIN_RADIUS))

    def with_aspect(self, aspect):
        return dataclasses.replace(self, aspect=aspect)

    def pose(self) -> "PoseCamera":
        """This orbit pose as a free PoseCamera (quaternion orientation)."""
        return PoseCamera.from_view_matrix(
            self.view_matrix(), self.position,
            fov_degrees=self.fov_degrees, near=self.near, far=self.far,
            aspect=self.aspect)


@dataclasses.dataclass(frozen=True)
class PoseCamera:
    """Free camera: world position + camera-to-world unit quaternion
    ``(x, y, z, w)``.

    The view matrix is the inverse rigid transform: rows are the camera
    basis vectors (world-to-camera rotation) with translation -R^T p — the
    matrix look_at_rh builds (Camera.cpp:52-71), parameterized so that poses
    compose and interpolate (quaternion slerp, AAPLMathUtilities.h:242).
    """

    position: tuple = (0.0, 0.0, 2.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    fov_degrees: float = 45.0
    near: float = 0.01
    far: float = 100.0
    aspect: float = 1.0

    @staticmethod
    def from_view_matrix(view, position, **kw):
        """Recover the pose from a world-to-camera view matrix."""
        r_c2w = _f32(view)[:3, :3].T
        return PoseCamera(position=_f32(position),
                          orientation=quaternion.from_matrix3x3(r_c2w), **kw)

    def view_matrix(self):
        q = quaternion.normalize(_f32(self.orientation))
        r_w2c = quaternion.to_matrix3x3(q).T
        p = _f32(self.position)
        t = -transforms.matmul(r_w2c, p[:, None])[:, 0]
        m = torch.eye(4, dtype=torch.float32)
        m[:3, :3] = r_w2c
        m[:3, 3] = t
        return m

    def projection_matrix(self):
        fov = _f32(self.fov_degrees) * (math.pi / 180.0)
        return transforms.perspective_rh(fov, self.aspect, self.near,
                                         self.far)

    def slerp(self, other: "PoseCamera", t):
        """Interpolated pose: slerp on orientation, lerp on everything
        else (all f32). t=0 -> self, t=1 -> other."""
        t = _f32(t)

        def lerp(a, b):
            return (1.0 - t) * _f32(a) + t * _f32(b)

        return PoseCamera(
            position=lerp(self.position, other.position),
            orientation=quaternion.slerp(_f32(self.orientation),
                                         _f32(other.orientation), t),
            fov_degrees=lerp(self.fov_degrees, other.fov_degrees),
            near=lerp(self.near, other.near),
            far=lerp(self.far, other.far),
            aspect=lerp(self.aspect, other.aspect))
