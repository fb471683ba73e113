"""metalrenderer_tpu_torch — the PyTorch/CUDA port of metalrenderer_tpu.

The same renderer (a Blinn-Phong rasterizer with shadow mapping, 4x MSAA,
an orbit camera and an audio-reactive scene), written in PyTorch, with the
JAX package's Pallas raster kernels replaced by CUDA C++ kernels for Hopper
(``csrc/raster.cu``, built with nvcc at first use). Tensors on the CPU take
the kernels' plain PyTorch twins. The package imports torch, never jax.
"""

from .config import RenderConfig, ShadowConfig
from .scene.camera import OrbitCamera
from .scene.lights import Lighting, PointLight
from .scene.materials import (BLINN_PHONG, BLINN_PHONG_SHADOW, EMISSIVE,
                              Material)
from .scene.mesh import Mesh, cube, plane
from .scene.scene import Instance, Scene
from .passes.pipeline import render_frame

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "ShadowConfig", "OrbitCamera", "Lighting", "PointLight",
    "Material", "BLINN_PHONG", "BLINN_PHONG_SHADOW", "EMISSIVE", "Mesh",
    "cube", "plane", "Instance", "Scene", "render_frame",
]
