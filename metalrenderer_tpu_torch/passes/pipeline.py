"""Two-pass render pipeline: shadow pass + main pass.

Torch counterpart of ``metalrenderer_tpu.passes.pipeline.render_frame``
with ``backend="pallas"`` and per-pixel shading on 8x128 main-pass tiles.
Frame anatomy (MtlEngine::draw, mtl_engine.mm:767-770):
  1. shadow pass: depth-only render of the shadow casters from the light
     (renderShadowPass, :772-792) -> kernel K1 ``raster_depth``;
  2. main pass, one of two branches:
     * fused (untextured scene, point light, ``fused_shade``): raster +
       Blinn-Phong/emissive shading + shadow test + MSAA coverage resolve
       in one launch -> kernel K2 ``render_fused``;
     * split (textures, normal maps, a directional light, or
       ``fused_shade=False``): per-pixel G-buffer raster -> kernel K3
       ``raster_gbuffer``, then ``channels_from_gout_px`` and
       ``shade.shade_channels``, whose shadow test runs kernel K7 and whose
       texture and normal-map lookups run kernel K9.
Everything between the kernels (vertex stage, clipping, triangle setup,
binning, the split path's elementwise shading) is ordinary tensor code on
the render device.

Entry points render on the GPU (``device="cuda"``) unless the caller asks
for the CPU; on a CUDA device the kernels run, on the CPU their plain twins.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig, ShadowConfig
from ..math import transforms
from ..raster import raster_cuda, shade
from ..raster.binning import bin_triangles, build_attr_fields, build_tri_fields
from ..raster.geometry import clip_near, guard_clip_xy, setup_triangles
from ..scene import lights as lights_mod
from ..scene.materials import BLINN_PHONG_SHADOW
from ..scene.scene import Scene, bake, project


@dataclasses.dataclass(frozen=True)
class PassGeometry:
    """Post-clip, per-pass triangle data consumed by the raster kernels."""

    vattrs: torch.Tensor     # f32[T_clipped, 3, 8] world | uv | normal
    mat_kind: torch.Tensor   # i32[T_clipped]
    mat_color: torch.Tensor  # f32[T_clipped, 3]
    tex_id: torch.Tensor     # i32[T_clipped]
    normal_map_id: torch.Tensor  # i32[T_clipped]


def resolve_device(device) -> torch.device:
    """The render device; a CUDA device without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but "
                           "torch.cuda.is_available() is false")
    return device


def prepare_main_pass(geom, view, proj, config: RenderConfig,
                      with_stats=False):
    """Project, near-clip, x/y guard-band clip (all with attribute
    interpolation) and set up triangles for the camera pass."""
    clip = project(geom.world, view, proj).reshape(-1, 3, 4)
    attrs = torch.cat([geom.world, geom.uvs, geom.normals],
                      dim=-1).reshape(-1, 3, 8)
    clip2, attrs2, parent = clip_near(clip, attrs)
    if config.xyclip_capacity > 0:
        clip2, attrs2, parent, gstats = guard_clip_xy(
            clip2, attrs2, parent, config.width, config.height,
            cap=config.xyclip_capacity, guard_px=config.guard_band_px)
    else:
        zero = torch.zeros((), dtype=torch.int32, device=clip.device)
        gstats = {"xyclip_triangles": zero, "xyclip_dropped": zero}
    setup = setup_triangles(
        clip2, config.width, config.height,
        cull_backfaces=config.cull_backfaces, near_eps=config.near_eps,
    )
    p = parent.to(torch.int64)
    pg = PassGeometry(
        vattrs=attrs2,
        mat_kind=geom.mat_kind[p],
        mat_color=geom.mat_color[p],
        tex_id=geom.tex_id[p],
        normal_map_id=geom.normal_map_id[p],
    )
    if with_stats:
        return setup, pg, gstats
    return setup, pg


def _wants_shadow(scene: Scene):
    """Does any instance cast AND any instance receive shadows?"""
    casts = any(i.cast_shadow for i in scene.instances)
    receives = any(
        i.material.kind == BLINN_PHONG_SHADOW for i in scene.instances
    )
    return casts and receives


def _fused_uniforms(m, camera, light_anchor, light, lighting, config):
    """Pack the shading uniforms (raster_cuda.FU_* layout: the fused
    kernel's, read by the split path's shading too), f32[33] on the CPU."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    return torch.cat([
        f32(m), f32(camera.position), f32(light_anchor), f32(light.color),
        f32(lighting.ambient_intensity), f32(lighting.shininess),
        f32(config.clear_color), f32(config.shadow_bias),
        f32(config.shadow_factor),
    ])


def _check_supported(lighting, config, backend):
    if backend != "kernels":
        raise NotImplementedError(
            f"backend={backend!r}: the port has only the tile-list kernels; "
            "a brute-force oracle is ROADMAP A11")
    if not isinstance(lighting.light, (lights_mod.PointLight,
                                       lights_mod.DirectionalLight)):
        raise TypeError(f"unknown light type {type(lighting.light)!r}")
    if not config.shading_per_pixel:
        raise NotImplementedError(
            "shading_per_pixel=False (supersampled shading) needs K3's "
            "per-sample G-buffer layout (ROADMAP A6b)")
    if (config.tile_h, config.tile_w) != (8, 128):
        raise NotImplementedError(
            "per-pixel G-buffers are binned on 8x128 main-pass tiles; other "
            "tile shapes need K3's per-sample layout (ROADMAP A6b)")


def _fused_ok(scene, lighting, config):
    """The JAX pipeline's ``fused_ok``: untextured scene, point light."""
    return (config.fused_shade and len(scene.textures) == 0
            and isinstance(lighting.light, lights_mod.PointLight))


@dataclasses.dataclass(frozen=True)
class FramePrep:
    """Everything a frame's kernel launches and shading read, built on the
    device."""

    shadow_bins: object      # TileBins of the shadow pass, or None
    main_bins: object        # TileBins (with attribute planes) of the main pass
    uniforms: torch.Tensor   # f32[FU_LEN] shading uniforms (FU_* layout)
    light_dir: torch.Tensor  # f32[3] a directional light's direction, or None
    textures: tuple          # the scene's mip chains on the device
    fused: bool              # the main pass takes the fused kernel (K2)
    stats: dict              # prep-side stats (0-d tensors)


def prepare_frame(scene: Scene, camera, lighting,
                  config: RenderConfig = RenderConfig(),
                  shadow_config: ShadowConfig = ShadowConfig(),
                  displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                  backend="kernels", device="cuda") -> FramePrep:
    """The host-side part of a frame: vertex stage, clipping, triangle
    setup and binning of both passes, and the uniforms. No kernel runs."""
    device = resolve_device(device)
    _check_supported(lighting, config, backend)
    scene = scene.to(device)
    geom = bake(scene, displacement)
    light = lighting.light
    light_anchor = lights_mod.light_anchor_position(
        light, shadow_target, shadow_config)
    stats = {"num_triangles": torch.tensor(geom.num_triangles,
                                           dtype=torch.int32, device=device)}

    shadow_bins = None
    m = torch.zeros((4, 4), dtype=torch.float32)
    if _wants_shadow(scene):
        light_view = lights_mod.light_view_matrix(
            light_anchor, torch.as_tensor(shadow_target, dtype=torch.float32))
        light_proj = lights_mod.light_projection_matrix(shadow_config)
        m = transforms.matmul(light_proj, light_view)
        clip_l = project(geom.world, light_view, light_proj)
        clip_l2, _, parent_l = clip_near(clip_l.reshape(-1, 3, 4))
        size = config.shadow_map_size
        setup_l = setup_triangles(clip_l2, size, size, cull_backfaces=False,
                                  near_eps=config.near_eps)
        # Only shadow casters contribute (the reference encodes only the
        # cube into the shadow pass, mtl_engine.mm:785-787).
        setup_l = setup_l.replace(
            valid=setup_l.valid & geom.cast_shadow[parent_l.to(torch.int64)])
        shadow_bins = bin_triangles(
            setup_l, build_tri_fields(setup_l), size, size,
            config.shadow_tile_w, config.shadow_tile_h,
            span_cap=config.span_cap, big_capacity=config.big_capacity)
        stats["shadow_big_dropped"] = shadow_bins.num_big_dropped

    setup, pg, gstats = prepare_main_pass(geom, camera.view_matrix(),
                                          camera.projection_matrix(), config,
                                          with_stats=True)
    stats["culled_triangles"] = (~setup.valid).sum().to(torch.int32)
    stats.update(gstats)
    stats["max_screen_coord"] = torch.amax(
        torch.where(setup.valid[:, None, None], torch.abs(setup.screen),
                    torch.zeros_like(setup.screen)))
    main_bins = bin_triangles(setup, build_tri_fields(setup), config.width,
                              config.height, config.tile_w, config.tile_h,
                              span_cap=config.span_cap,
                              big_capacity=config.big_capacity,
                              attr_fields=build_attr_fields(setup, pg))
    stats["big_dropped"] = main_bins.num_big_dropped
    uniforms = _fused_uniforms(m, camera, light_anchor, light, lighting,
                               config).to(device)
    light_dir = None
    if isinstance(light, lights_mod.DirectionalLight):
        light_dir = torch.as_tensor(light.direction,
                                    dtype=torch.float32).to(device)
    return FramePrep(shadow_bins, main_bins, uniforms, light_dir,
                     scene.textures, _fused_ok(scene, lighting, config),
                     stats)


def render_frame(scene: Scene, camera, lighting,
                 config: RenderConfig = RenderConfig(),
                 shadow_config: ShadowConfig = ShadowConfig(),
                 displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                 backend="kernels", device="cuda"):
    """Render one frame on ``device``. Returns (framebuffer f32[H,W,4] and a
    stats dict of 0-d tensors, both on ``device``)."""
    prep = prepare_frame(scene, camera, lighting, config, shadow_config,
                         displacement, shadow_target, backend, device)
    stats = dict(prep.stats)
    shadow_map = None
    if prep.shadow_bins is not None:
        size = config.shadow_map_size
        depth, _ = raster_cuda.raster_depth(prep.shadow_bins, size, size,
                                            ((0.5, 0.5),), clear_depth=1.0)
        shadow_map = depth[0]
        stats["shadow_min_depth"] = torch.amin(shadow_map)
    samples = tuple(config.sample_positions)
    if prep.fused:
        rgba, covf = raster_cuda.render_fused(
            prep.main_bins, prep.uniforms, shadow_map, config.width,
            config.height, samples, clear_depth=config.clear_depth)
        stats["covered_fraction"] = torch.mean(covf)
        return rgba, stats

    gout, _, _ = raster_cuda.raster_gbuffer(
        prep.main_bins, config.width, config.height, samples,
        clear_depth=config.clear_depth)
    ch = raster_cuda.channels_from_gout_px(gout, len(samples))
    u = prep.uniforms
    shadow_ctx = None
    if shadow_map is not None:
        shadow_ctx = shade.ShadowContext(
            depth_map=shadow_map,
            light_m=u[raster_cuda.FU_M:raster_cuda.FU_M + 16].reshape(4, 4))
    r, g, b, a = shade.shade_channels(
        ch,
        camera_pos=u[raster_cuda.FU_CAM:raster_cuda.FU_CAM + 3],
        light_pos=u[raster_cuda.FU_LPOS:raster_cuda.FU_LPOS + 3],
        light_color=u[raster_cuda.FU_LCOL:raster_cuda.FU_LCOL + 3],
        ambient_intensity=u[raster_cuda.FU_AMB],
        shininess=u[raster_cuda.FU_SHIN],
        clear_color=u[raster_cuda.FU_CLEAR:raster_cuda.FU_CLEAR + 4],
        shadow=shadow_ctx, textures=prep.textures,
        shadow_bias=u[raster_cuda.FU_BIAS],
        shadow_factor_value=u[raster_cuda.FU_FACTOR],
        light_dir=prep.light_dir)
    stats["covered_fraction"] = torch.mean(ch["cov_frac"])
    return torch.stack([r, g, b, a], dim=-1), stats
