"""One frame by the reference: the shadow pass, the main pass and the
shading, brute force, from a scene description and the frame's inputs.

The same stages as the port's ``backend="reference"`` path (a frozen copy
of ``passes/pipeline.py``'s ``prepare_frame``, ``prepare_main_pass``,
``_render_reference`` and ``_split_shade``): the vertex stage, near and
guard-band clipping, triangle setup, brute-force visibility with the tile
anchor of the configuration, perspective-correct interpolation, and the
Blinn-Phong / emissive / shadow-test / normal-map / color-texture fragment
stage under a point or a directional light, once per pixel at the first
covered sample, blended by the covered share of the samples.

``round_to`` is the precision of the control: ``None`` keeps float32; a
dtype (``torch.bfloat16``) rounds every stage's float values to it on the
way through: world positions and normals after the vertex stage, clip
coordinates, the interpolated G-buffer, the textures' mip chains, the
shading uniforms and the shaded rgba.
"""
from __future__ import annotations

import torch

from . import geometry, raster, scene as sc, shading, transforms


def rounder(round_to):
    """The identity, or a rounding of float tensors to ``round_to`` and
    back to float32."""
    if round_to is None:
        return lambda t: t
    return lambda t: t.to(round_to).to(torch.float32)


def _main_pass_geometry(geom, camera, config, q):
    clip = q(sc.project(geom.world, camera.view_matrix(),
                        camera.projection_matrix()).reshape(-1, 3, 4))
    attrs = torch.cat([geom.world, geom.uvs, geom.normals],
                      dim=-1).reshape(-1, 3, 8)
    clip2, attrs2, parent = geometry.clip_near(clip, attrs)
    if config.xyclip_capacity > 0:
        clip2, attrs2, parent, _ = geometry.guard_clip_xy(
            clip2, attrs2, parent, config.width, config.height,
            cap=config.xyclip_capacity, guard_px=config.guard_band_px)
    setup = geometry.setup_triangles(clip2, config.width, config.height,
                                     cull_backfaces=config.cull_backfaces,
                                     near_eps=config.near_eps)
    return setup, attrs2, parent.to(torch.int64)


def _shadow_setup(geom, light_anchor, shadow_target, shadow_config, config,
                  q):
    light_view = sc.light_view_matrix(
        light_anchor, torch.as_tensor(shadow_target, dtype=torch.float32))
    light_proj = sc.light_projection_matrix(shadow_config)
    m = transforms.matmul(light_proj, light_view)
    clip_l = q(sc.project(geom.world, light_view, light_proj))
    clip_l2, _, parent_l = geometry.clip_near(clip_l.reshape(-1, 3, 4))
    size = config.shadow_map_size
    setup_l = geometry.setup_triangles(clip_l2, size, size,
                                       cull_backfaces=False,
                                       near_eps=config.near_eps)
    # Only casters write the map (mtl_engine.mm:785-787).
    setup_l = setup_l.replace(valid=setup_l.valid & geom.cast_shadow[
        parent_l.to(torch.int64)])
    return setup_l, m


def render(instances, camera, lighting, config, shadow_config, displacement,
           shadow_target, device, round_to=None, count=False, textures=()):
    """rgba f32[H, W, 4] of one frame on ``device``; with ``count``, also
    the work it needs: {"main": n, "shadow": n} (``raster.
    count_fragments`` of each pass) and the pixels its fragment stage
    shades: "shaded" (a covered sample), of those "normal_mapped" (under
    a normal map), "textured" (under a color texture) and "shadow_tested"
    (a receiver of the shadow map, where the frame has one).
    ``textures``: the frame's mip chains on ``device``
    (``scene.texture_chains``)."""
    q = rounder(round_to)
    geom = sc.bake(instances, displacement, device)
    geom = sc.PackedGeometry(**dict(geom.__dict__, world=q(geom.world),
                                    normals=q(geom.normals)))
    light = lighting.light
    light_anchor = sc.light_anchor_position(light, shadow_target,
                                            shadow_config)
    light_dir = (light.direction if isinstance(light, sc.DirectionalLight)
                 else None)
    textures = tuple(tuple(q(level) for level in mips) for mips in textures)
    casts = any(i.cast_shadow for i in instances)
    receives = any(i.kind == sc.BLINN_PHONG_SHADOW for i in instances)
    shadow_ctx, fragments = None, {"main": 0, "shadow": 0}
    if casts and receives:
        setup_l, m = _shadow_setup(geom, light_anchor, shadow_target,
                                   shadow_config, config, q)
        size = config.shadow_map_size
        depth_map = raster.rasterize_depth_brute_force(
            setup_l, size, size,
            anchor=(config.shadow_tile_w, config.shadow_tile_h))
        shadow_ctx = shading.ShadowContext(depth_map=depth_map,
                                           light_m=m.to(device))
        if count:
            fragments["shadow"] = raster.count_fragments(
                setup_l, size, size, ((0.5, 0.5),))
    setup, vattrs, parent = _main_pass_geometry(geom, camera, config, q)
    samples = tuple(config.sample_positions)
    depth, winner = raster.rasterize_brute_force(
        setup, config.width, config.height, samples,
        anchor=(config.tile_w, config.tile_h))
    if count:
        fragments["main"] = raster.count_fragments(
            setup, config.width, config.height, samples)
    gbuf = raster.interpolate_gbuffer(
        setup, winner, config.width, config.height, samples, vattrs,
        geom.mat_kind[parent], geom.mat_color[parent], geom.tex_id[parent],
        depth, normal_map_id=geom.normal_map_id[parent])
    gbuf = gbuf.replace(world=q(gbuf.world), normal=q(gbuf.normal),
                        uv=q(gbuf.uv), mat_color=q(gbuf.mat_color))
    if count:
        fragments.update(_shaded_pixels(gbuf, shadow_ctx is not None))

    def u(x):
        return q(torch.as_tensor(x, dtype=torch.float32).to(device))

    if shadow_ctx is not None:
        shadow_ctx = shading.ShadowContext(shadow_ctx.depth_map,
                                           q(shadow_ctx.light_m))
    r, g, b, a = shading.shade_channels(
        shading.channels_from_gbuffer(gbuf),
        camera_pos=u(camera.position), light_pos=u(light_anchor),
        light_color=u(light.color),
        ambient_intensity=u(lighting.ambient_intensity),
        shininess=u(lighting.shininess), clear_color=u(config.clear_color),
        shadow=shadow_ctx, textures=textures,
        shadow_bias=u(config.shadow_bias),
        shadow_factor_value=u(config.shadow_factor),
        light_dir=None if light_dir is None else u(light_dir),
        shadow_per_pixel=config.shadow_per_pixel,
        per_pixel=config.shading_per_pixel)
    if r.dim() == 3:
        # Supersampled: the MSAA box resolve.
        r, g, b, a = (torch.mean(c, dim=0) for c in (r, g, b, a))
    rgba = q(torch.stack([r, g, b, a], dim=-1))
    return (rgba, fragments) if count else rgba


def _shaded_pixels(gbuf, shadow):
    """Pixels the fragment stage shades, once each at its first covered
    sample (``shading._first_covered`` over the [S, H, W] planes):
    {"shaded": n, "normal_mapped": n, "textured": n, "shadow_tested": n}."""
    (nmid, texid, kind), covered = shading._first_covered(
        [gbuf.normal_map_id, gbuf.tex_id, gbuf.mat_kind], gbuf.covered)
    tested = covered & (kind == sc.BLINN_PHONG_SHADOW)
    return {"shaded": int(covered.sum()),
            "normal_mapped": int((covered & (nmid >= 0)).sum()),
            "textured": int((covered & (texid >= 0)).sum()),
            "shadow_tested": int(tested.sum()) if shadow else 0}
