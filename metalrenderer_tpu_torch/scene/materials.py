"""Materials (torch counterpart of ``metalrenderer_tpu.scene.materials``).

The reference has three fragment paths, selected per draw call
(mtl_engine.mm:821-877): Blinn-Phong without shadow sampling
(BlinnPhong.metal:40-58, the main cube), Blinn-Phong with the shadow-map test
(BlinnPhong.metal:60-97, the floor) and a flat emissive color
(light.metal:27-29, the light cube). A material is data; the fused kernel
branches on ``kind``.
"""
from __future__ import annotations

import dataclasses

import torch

# Material kinds (values baked per triangle into the attribute table).
BLINN_PHONG = 0          # lit, does not sample the shadow map
BLINN_PHONG_SHADOW = 1   # lit + shadow-map test (BlinnPhong.metal:79-96)
EMISSIVE = 2             # flat color


@dataclasses.dataclass(frozen=True)
class Material:
    color: torch.Tensor                 # f32[3] materialColor / lightColor
    kind: int = BLINN_PHONG
    # Indices into Scene.textures; -1 = none.
    texture_id: int = -1
    normal_map_id: int = -1

    def to(self, device):
        return dataclasses.replace(self, color=self.color.to(device))


def cube_material(device="cpu"):
    """Main cube: color {1.0, 0.5, 0.31} (mtl_engine.mm:823)."""
    return Material(color=torch.tensor([1.0, 0.5, 0.31], dtype=torch.float32,
                                       device=device),
                    kind=BLINN_PHONG)


def plane_material(device="cpu"):
    """Floor plane: color {0.5, 0.7, 0.5} (mtl_engine.mm:874), receives shadow."""
    return Material(color=torch.tensor([0.5, 0.7, 0.5], dtype=torch.float32,
                                       device=device),
                    kind=BLINN_PHONG_SHADOW)


def emissive_material(color, device="cpu"):
    return Material(color=torch.as_tensor(color, dtype=torch.float32,
                                          device=device), kind=EMISSIVE)
