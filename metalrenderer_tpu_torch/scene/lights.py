"""Light types (torch counterpart of ``metalrenderer_tpu.scene.lights``).

The reference has one point light (LightingData, VertexData.hpp:20-28) whose
shadow-pass view is an ortho projection looking at the main cube with an
adaptive up vector (mtl_engine.mm:668-690). Lighting is host-side state,
packed into the kernels' uniforms each frame. A directional light (BASELINE
config 4's sun) is at infinity; it takes the split path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ShadowConfig
from ..math import transforms


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class PointLight:
    """Values are anything ``torch.as_tensor`` takes (tuples, f32 tensors)."""

    position: tuple = (0.0, 2.0, 0.0)   # mtl_engine.hpp:154 default
    color: tuple = (1.0, 1.0, 1.0)      # mtl_engine.hpp:156
    intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """``direction`` points FROM the light (values as for PointLight)."""

    direction: tuple = (0.0, -1.0, -0.3)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class Lighting:
    """Global lighting parameters (LightingData, VertexData.hpp:20-28;
    values set at mtl_engine.mm:755-758: ambient 0.1, shininess 32)."""

    light: PointLight = None
    ambient_intensity: float = 0.1
    shininess: float = 32.0

    @staticmethod
    def default():
        return Lighting(light=PointLight())


def light_anchor_position(light, shadow_target,
                          shadow: ShadowConfig = ShadowConfig()):
    """World position anchoring the shadow pass's light view.

    A point light uses its own position (mtl_engine.mm:668). A directional
    light's shadow camera sits along -direction from the target at
    mid-ortho-depth, so casters near the target land inside the [near, far]
    depth range of the ortho volume."""
    if isinstance(light, DirectionalLight):
        d = transforms.normalize(_f32(light.direction))
        standoff = 0.5 * (shadow.near + shadow.far)
        return _f32(shadow_target) - d * standoff
    return _f32(light.position)


def adaptive_up(forward):
    """Pick a world-up axis from the smallest |forward| component, exactly
    reproducing the if-chain at mtl_engine.mm:672-683."""
    af = torch.abs(forward)
    if bool((af[1] < af[0]) & (af[1] < af[2])):
        return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
    if bool(af[0] < af[2]):
        return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32)
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)


def light_view_matrix(light_pos, look_target):
    """Light view used by the shadow pass (mtl_engine.mm:668-690):
    forward = normalize(target - pos); adaptive world-up; right/up rebuilt;
    then a RH look-at."""
    light_pos = _f32(light_pos)
    look_target = _f32(look_target)
    forward = transforms.normalize(look_target - light_pos)
    world_up = adaptive_up(forward)
    right = transforms.normalize(transforms.cross(forward, world_up))
    up = transforms.cross(right, forward)
    return transforms.look_at_rh(light_pos, look_target, up)


def light_projection_matrix(shadow: ShadowConfig = ShadowConfig()):
    """Ortho light projection (mtl_engine.mm:645-646)."""
    return transforms.ortho_rh(
        shadow.left, shadow.right, shadow.bottom, shadow.top,
        shadow.near, shadow.far,
    )
