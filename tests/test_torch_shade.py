"""Port parity, the deferred fragment stage: the port's
``shade.shade_channels`` against the JAX package's
(``shade_channels(tiled_sampler=False)``) on the SAME channel planes, per
pixel ([H, W] planes with a covered fraction) and on [S, H, W] sample
planes in its three modes: BASELINE config 4's main pass at 96x72 MSAA4 (a
directional light, its shadow map, the normal-mapped cube), with the floor
given a color texture (the grass) so all three texture paths run.

Tolerance: 1e-5 absolute on rgba — shading divides, takes square roots, a
``log2`` (the LOD) and a ``pow`` that XLA:CPU and torch evaluate with
different approximations and FMA contraction (the bar K2 is held to in
tests/test_torch_raster.py).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.raster import shade as j_shade
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene.lights import DirectionalLight as JDirectional

from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app, configs
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import (mip_cuda, raster_cuda,
                                            sample_cuda, shade)
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import (Lighting, PointLight,
                                                  light_anchor_position)
from metalrenderer_tpu_torch.scene.materials import BLINN_PHONG_SHADOW
from metalrenderer_tpu_torch.scene.scene import Scene

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_shade_channels_matches_jax():
    w, h = 96, 72
    scene, cam, lighting, cfg = configs.config4_shadow_normal_map(
        w, h, device="cpu")
    cfg = cfg.replace(shadow_map_size=128)
    cube, floor = scene.instances
    floor = dataclasses.replace(
        floor, material=dataclasses.replace(floor.material, texture_id=1))
    scene = Scene(instances=(cube, floor),
                  textures=(scene.textures[0], audio_app.grass_texture()))
    prep = pipeline.prepare_frame(scene, cam, lighting, cfg, device="cpu")
    smap = raster_cuda.raster_depth(prep.shadow_bins, 128, 128,
                                    ((0.5, 0.5),))[0][0]
    gout = raster_cuda.raster_gbuffer(prep.main_bins, w, h,
                                      tuple(cfg.sample_positions))[0]
    ch = raster_cuda.channels_from_gout_px(gout, 4)
    covered = ch["covered"]
    assert bool(((ch["nmid"] == 0) & covered).any())
    assert bool(((ch["texid"] == 1) & covered).any())

    light = lighting.light
    anchor = light_anchor_position(light, (0.0, 0.0, 0.0))
    shadow = shade.ShadowContext(depth_map=smap,
                                 light_m=prep.uniforms[:16].reshape(4, 4))
    out_p = shade.shade_channels(
        ch, cam.position, anchor, light.color, 0.1, 32.0, cfg.clear_color,
        shadow=shadow, textures=scene.textures, light_dir=light.direction)

    jlight = JDirectional(direction=jnp.asarray(light.direction, jnp.float32))
    janchor = j_lights.light_anchor_position(jlight, (0.0, 0.0, 0.0))
    jshadow = j_shade.ShadowContext(
        depth_map=_j(smap), light_view=j_lights.light_view_matrix(
            janchor, jnp.zeros(3, jnp.float32)),
        light_proj=j_lights.light_projection_matrix())
    out_j = j_shade.shade_channels(
        {k: _j(v) for k, v in ch.items()}, _j(cam.position), janchor,
        light.color, 0.1, 32.0, cfg.clear_color, shadow_ctx=jshadow,
        textures=tuple(tuple(_j(m) for m in mips) for mips in scene.textures),
        tiled_sampler=False, return_planes=True, light_dir=light.direction,
        per_pixel=True)
    for p, j in zip(out_p, out_j):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
    # The shadow test ran: some floor pixels are darkened by the factor.
    receives = (ch["kind"] == BLINN_PHONG_SHADOW) & covered
    sf = shade._shadow_factor_soa(
        (ch["wx"], ch["wy"], ch["wz"]), shadow.light_m, smap, 0.005, 0.5,
        receives)
    assert bool((sf[receives] == 0.5).any())


def _sample_channels(w, h, cfg, scene, cam, lighting):
    """[S, H, W] channels of a frame's per-sample G-buffer (K3s twin), its
    shadow map and prep."""
    prep = pipeline.prepare_frame(scene, cam, lighting, cfg, device="cpu")
    size = cfg.shadow_map_size
    smap = raster_cuda.raster_depth(prep.shadow_bins, size, size,
                                    ((0.5, 0.5),))[0][0]
    gout, _, winner = raster_cuda.raster_gbuffer_samples(
        prep.main_bins, w, h, tuple(cfg.sample_positions))
    return raster_cuda.channels_from_gout(gout, winner), smap, prep


@pytest.mark.parametrize("mode", ["per_pixel", "supersampled",
                                  "supersampled_shadow_per_sample"])
def test_shade_channels_sample_planes_match_jax(mode):
    """The three modes of ``shade_channels`` on [S, H, W] sample planes
    (BASELINE config 4 at 64x48 MSAA4 with the grass on the floor: normal
    map, color texture, directional light, shadow map): the fragment at
    the first covered sample with the coverage blend; every sample shaded,
    with one shadow test per pixel; and with one per sample. Against the
    JAX function on the same planes, 1e-5 absolute as above."""
    w, h = 64, 48
    scene, cam, lighting, cfg = configs.config4_shadow_normal_map(
        w, h, device="cpu")
    cfg = cfg.replace(shadow_map_size=128)
    cube, floor = scene.instances
    floor = dataclasses.replace(
        floor, material=dataclasses.replace(floor.material, texture_id=1))
    scene = Scene(instances=(cube, floor),
                  textures=(scene.textures[0], audio_app.grass_texture()))
    ch, smap, prep = _sample_channels(w, h, cfg, scene, cam, lighting)
    covered = ch["covered"]
    assert covered.shape == (4, h, w) and "cov_frac" not in ch
    partial = covered.any(dim=0) & ~covered.all(dim=0)
    assert bool(partial.any())                       # edge pixels exist
    assert bool(((ch["nmid"] == 0) & covered).any())
    assert bool(((ch["texid"] == 1) & covered).any())
    per_pixel = mode == "per_pixel"
    shadow_per_pixel = mode != "supersampled_shadow_per_sample"

    light = lighting.light
    anchor = light_anchor_position(light, (0.0, 0.0, 0.0))
    shadow = shade.ShadowContext(depth_map=smap,
                                 light_m=prep.uniforms[:16].reshape(4, 4))
    before = (dict(sample_cuda.LAUNCHES), dict(mip_cuda.LAUNCHES))
    out_p = shade.shade_channels(
        ch, cam.position, anchor, light.color, 0.1, 32.0, cfg.clear_color,
        shadow=shadow, textures=scene.textures, light_dir=light.direction,
        shadow_per_pixel=shadow_per_pixel, per_pixel=per_pixel)
    assert (dict(sample_cuda.LAUNCHES), dict(mip_cuda.LAUNCHES)) == before

    jlight = JDirectional(direction=jnp.asarray(light.direction, jnp.float32))
    janchor = j_lights.light_anchor_position(jlight, (0.0, 0.0, 0.0))
    jshadow = j_shade.ShadowContext(
        depth_map=_j(smap), light_view=j_lights.light_view_matrix(
            janchor, jnp.zeros(3, jnp.float32)),
        light_proj=j_lights.light_projection_matrix())
    out_j = j_shade.shade_channels(
        {k: _j(v) for k, v in ch.items()}, _j(cam.position), janchor,
        light.color, 0.1, 32.0, cfg.clear_color, shadow_ctx=jshadow,
        textures=tuple(tuple(_j(m) for m in mips) for mips in scene.textures),
        tiled_sampler=False, return_planes=True, light_dir=light.direction,
        shadow_per_pixel=shadow_per_pixel, per_pixel=per_pixel)
    for p, j in zip(out_p, out_j):
        assert p.shape == ((h, w) if per_pixel else (4, h, w))
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
    if per_pixel:
        # A partially covered pixel blends toward the clear color.
        a = out_p[3]
        assert bool((a[covered.all(dim=0)] > 0.49).all())
    else:
        # Uncovered samples carry the clear color exactly.
        clear = torch.tensor(cfg.clear_color)
        for c, plane in enumerate(out_p):
            assert bool((plane[~covered] == clear[c]).all())


def test_shade_channels_msaa1_modes_agree():
    """With one sample the three modes are the same function
    (tests/test_per_pixel_shading.py: per-pixel is a no-op at MSAA1)."""
    w, h = 48, 40
    cfg = RenderConfig(width=w, height=h, msaa=1, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
    lighting = Lighting(light=PointLight())
    ch, smap, prep = _sample_channels(w, h, cfg,
                                      audio_app.build_scene(device="cpu"),
                                      cam, lighting)
    shadow = shade.ShadowContext(depth_map=smap,
                                 light_m=prep.uniforms[:16].reshape(4, 4))
    outs = [shade.shade_channels(
        ch, cam.position, (0.0, 2.0, 0.0), (1.0, 1.0, 1.0), 0.1, 32.0,
        cfg.clear_color, shadow=shadow, shadow_per_pixel=sp, per_pixel=pp)
        for pp, sp in ((True, True), (False, True), (False, False))]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert a.shape == (1, h, w) and torch.equal(a, b)
