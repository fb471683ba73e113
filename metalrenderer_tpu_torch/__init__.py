"""metalrenderer_tpu_torch — the PyTorch/CUDA port of metalrenderer_tpu.

The same renderer (a Blinn-Phong rasterizer with shadow mapping, 4x MSAA,
an orbit camera, textures, normal maps, point and directional lights and an
audio-reactive scene driven by an audio analysis pipeline: ``audio/``,
``engine/renderer.py``), written in PyTorch, with the JAX package's Pallas
kernels replaced by CUDA C++ kernels for Hopper (``csrc/raster.cu``,
``csrc/sample.cu``, built with nvcc at first use). Entry points render on
the GPU unless the caller asks for the CPU; tensors on the CPU take the
kernels' plain PyTorch twins. ``backend="reference"`` renders with the
brute-force oracle (``raster/reference_cpu.py``) instead of the kernels,
and ``parallel/sharding.py`` splits a frame batch or one frame's rows over
the ranks of a ``torch.distributed`` group. The app layer (``cli.py``,
run as ``python -m metalrenderer_tpu_torch.cli``, and
``engine/session.py``) and the utilities (``utils/``) sit on top. The
package imports torch, never jax.
"""

from .config import RenderConfig, ShadowConfig
from .scene.camera import OrbitCamera, PoseCamera
from .scene.lights import DirectionalLight, Lighting, PointLight
from .scene.materials import (BLINN_PHONG, BLINN_PHONG_SHADOW, EMISSIVE,
                              Material)
from .scene.mesh import Mesh, cube, plane, square, triangle, uv_sphere
from .scene.scene import Instance, Scene
from .passes.pipeline import render, render_batch, render_frame

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "ShadowConfig", "OrbitCamera", "PoseCamera",
    "Lighting", "PointLight",
    "DirectionalLight", "Material", "BLINN_PHONG", "BLINN_PHONG_SHADOW",
    "EMISSIVE", "Mesh", "cube", "plane", "square", "triangle", "uv_sphere",
    "Instance", "Scene", "render", "render_batch", "render_frame",
]
