"""The flagship "AudioApp" scene: Blinn-Phong cube + emissive light cube +
shadow-receiving floor plane with audio-reactive displacement.

Torch counterpart of ``metalrenderer_tpu.engine.audio_app`` (scene, default
camera, one frame):
  * main cube at ``cube_position`` (default {0,0,-1}, mtl_engine.hpp:155),
    color {1.0,0.5,0.31} (mtl_engine.mm:823), audio displacement enabled;
  * light cube at ``light_position`` (default {0,2,0}), emissive with the
    light color (mtl_engine.mm:849-850);
  * floor plane: translate(0,-1,0) @ scale(10,1,10) (mtl_engine.mm:655-656),
    color {0.5,0.7,0.5} (mtl_engine.mm:874), receives the shadow;
  * shadow caster: the main cube, with its own model matrix (the reference
    uses the light's, mtl_engine.mm:692-697 — a documented deviation);
  * optionally the cube textured (``textures=``, ``cube_texture_id=``),
    e.g. with the bundled grass texture (``grass_texture``), which sends
    the frame down the split path.
"""
from __future__ import annotations

import dataclasses
import pathlib

from ..config import RenderConfig, ShadowConfig
from ..io.textures import load_texture
from ..math import transforms
from ..passes.pipeline import render_frame, resolve_device
from ..scene import materials, mesh
from ..scene.camera import OrbitCamera
from ..scene.lights import Lighting, PointLight
from ..scene.scene import Instance, Scene


def build_scene(cube_position=(0.0, 0.0, -1.0),
                light_position=(0.0, 2.0, 0.0),
                light_color=(1.0, 1.0, 1.0), textures=(), cube_texture_id=-1,
                device="cuda") -> Scene:
    device = resolve_device(device)
    cube_mat = materials.cube_material()
    if cube_texture_id >= 0:
        cube_mat = dataclasses.replace(cube_mat, texture_id=cube_texture_id)
    cube_model = transforms.translation(*cube_position)
    light_model = transforms.translation(*light_position)
    plane_model = transforms.matmul(transforms.translation(0.0, -1.0, 0.0),
                                    transforms.scale(10.0, 1.0, 10.0))
    instances = (
        Instance(mesh=mesh.cube(), model_matrix=cube_model,
                 material=cube_mat, cast_shadow=True,
                 use_displacement=True),
        Instance(mesh=mesh.cube(), model_matrix=light_model,
                 material=materials.emissive_material(light_color),
                 cast_shadow=False, use_displacement=False),
        Instance(mesh=mesh.plane(), model_matrix=plane_model,
                 material=materials.plane_material(),
                 cast_shadow=False, use_displacement=False),
    )
    return Scene(instances=instances, textures=tuple(textures)).to(device)


def default_camera(width=800, height=600) -> OrbitCamera:
    return OrbitCamera(aspect=float(width) / float(height))


def grass_texture():
    """The bundled Metal-Tutorial grass texture as a mip chain (the
    reference loads assets/mc_grass.jpeg with stb_image, Texture.cpp:3-24;
    the repository bundles a lossless PNG conversion)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    return load_texture(root / "assets" / "mc_grass.png")


def render_audio_app(cube_position=(0.0, 0.0, -1.0),
                     light_position=(0.0, 2.0, 0.0),
                     light_color=(1.0, 1.0, 1.0),
                     displacement=0.0,
                     camera: OrbitCamera = None,
                     config: RenderConfig = RenderConfig(),
                     shadow_config: ShadowConfig = ShadowConfig(),
                     backend="kernels", textures=(), cube_texture_id=-1,
                     device="cuda", scene: Scene = None):
    """One AudioApp frame on ``device``; returns (framebuffer, stats).

    ``scene``: a prebuilt ``build_scene(...)`` on the device (a server keeps
    one and renders many frames from it); built here when omitted, with
    ``textures`` and ``cube_texture_id``.
    """
    if scene is None:
        scene = build_scene(cube_position, light_position, light_color,
                            textures, cube_texture_id, device=device)
    if camera is None:
        camera = default_camera(config.width, config.height)
    lighting = Lighting(
        light=PointLight(position=light_position, color=light_color,
                         intensity=1.0),
        ambient_intensity=0.1,   # mtl_engine.mm:757
        shininess=32.0,          # mtl_engine.mm:758
    )
    return render_frame(scene, camera, lighting, config, shadow_config,
                        displacement=displacement,
                        shadow_target=cube_position, backend=backend,
                        device=device)
