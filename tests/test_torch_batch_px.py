"""Port parity, the frame-batch API's px (split) branch:
``render_frame_batch_px`` (K4 shadow maps, K5 G-buffers, the split shading
on [F, H, W] planes with K8 for the shadow test and K9 for textures, run by
their plain twins on the CPU) against the JAX ``render_frame_batch_px`` in
interpret mode, on the JAX package's own cases (tests/test_fused_batch.py:
BASELINE config 1, the textured cube, and config 4, the shadow-casting
normal-mapped cube under a directional sun, at 128x64 MSAA4 with a 64^2
shadow map and two orbit angles each); ``render_batch``'s dispatch to this
branch, cameras carried across from a stacked JAX camera pytree, config 1
through ``render_frame``, K5's and K8's twins against
``rasterize_tiles_batch`` and ``sample_bilinear_tiled_batch``, and the
shadow pass's span cap.

Tolerances, with their reasons:
  * covered fractions within 1e-6 (the same counts, averaged in another
    order), integer stats equal;
  * rgba against JAX >= 60 dB PSNR and max abs error <= 2e-4. Measured:
    config 1 3.4e-6; config 4 1.35e-4, on 24 and 19 pixels of the
    normal-mapped cube above 1e-5 (the same with ``shadow_factor=1``, so
    not the shadow test). The port's ``render_frame`` differs from the JAX
    package's (``backend="pallas"``) by exactly as much, pixel for pixel,
    which the test asserts: the prep's and the shading's rounding
    (XLA:CPU contracts multiply-adds into FMAs, ROADMAP C6), magnified
    where the normal map's screen-space tangent frame divides by the uv
    derivatives' determinant;
  * every batch frame BIT-EQUAL to the port's own ``render_frame``;
  * K5 gout: covered counts equal, attribute rows bit-equal to a numpy
    evaluation that rounds every step, and as K3's in
    ``test_torch_raster``: within 1e-6 relative of the interpret-mode
    kernel (C6) but for a count of values fixed per frame at the count
    measured (its planes of value/w on long guard-band triangles, C13),
    and within 1e-4 of the JAX reference;
  * K8: within 1e-6 of exact bilinear sampling frame by frame, and within
    one ulp of the texture width of ``sample_bilinear_tiled_batch`` (the
    tolerance the K7 test holds: the Pallas kernel's coordinates round
    differently).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalrenderer_tpu import render as j_render
from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.config import ShadowConfig as JShadow
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.passes import pipeline as j_pipe
from metalrenderer_tpu.raster import binning as jb
from metalrenderer_tpu.raster import raster_pallas, sample_pallas
from metalrenderer_tpu.raster import sampling as j_sampling
from metalrenderer_tpu.raster.geometry import clip_near, setup_triangles
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene.scene import bake, project

from benchmarks import configs as j_configs

from test_torch_raster import (_first_sample, _near_pallas, _numpy_gout,
                               _reference_gout)

from metalrenderer_tpu_torch import convert, render_batch
from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app, configs
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.passes import prep as frame_prep
from metalrenderer_tpu_torch.raster import (binning, mip_cuda, raster_cuda,
                                            sample_cuda, sampling)
from metalrenderer_tpu_torch.scene.lights import Lighting

torch.set_num_threads(2)
W, H = 128, 64
SAMPLES = tuple(JConfig(msaa=4).sample_positions)
DTHETA = {"config1": 0.4, "config4": 0.3}      # tests/test_fused_batch.py


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _launches():
    return {**raster_cuda.LAUNCHES, **sample_cuda.LAUNCHES,
            **mip_cuda.LAUNCHES}


def _port_case(name):
    """(scene, camera, lighting, config, thetas) of the port at 128x64."""
    build = (configs.config1_textured_cube if name == "config1"
             else configs.config4_shadow_normal_map)
    scene, cam, light, cfg = build(W, H, device="cpu")
    t0 = float(np.float32(cam.theta))
    thetas = [t0, float(np.float32(t0 + DTHETA[name]))]
    return scene, cam, light, cfg.replace(shadow_map_size=64), thetas


def _jax_case(name):
    build = (j_configs.config1_textured_cube if name == "config1"
             else j_configs.config4_shadow_normal_map)
    scene, cam, light, cfg = build()
    cfg = cfg.replace(width=W, height=H, msaa=4, shadow_map_size=64)
    return scene, cam.replace(aspect=2.0), light, cfg


@functools.cache
def _port_px(name):
    scene, cam, light, cfg, thetas = _port_case(name)
    before = _launches()
    out = pipeline.render_frame_batch_px(scene, cam, light, cfg,
                                         ShadowConfig(), [0.0, 0.0], thetas,
                                         device="cpu")
    assert _launches() == before                 # CPU: the twins ran
    return out


@pytest.mark.parametrize("name", ["config1", "config4"])
def test_px_batch_matches_jax_and_render_frame(name):
    rgba, stats = _port_px(name)
    scene, cam, light, cfg, thetas = _port_case(name)
    js, jcam, jl, jcfg = _jax_case(name)
    rgba_j, stats_j = j_pipe.render_frame_batch_px(
        js, jcam, jl, jcfg, JShadow(), jnp.zeros(2, jnp.float32),
        jnp.asarray(thetas, jnp.float32))
    rgba_j = np.asarray(rgba_j)
    assert rgba.shape == rgba_j.shape == (2, H, W, 4)
    np.testing.assert_allclose(stats["covered_fraction"].numpy(),
                               np.asarray(stats_j["covered_fraction"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(stats["big_dropped"].numpy(),
                                  np.asarray(stats_j["big_dropped"]))
    for f in range(2):
        assert _psnr(rgba[f].numpy(), rgba_j[f]) >= 60.0, f
    assert float(np.abs(rgba.numpy() - rgba_j).max()) <= 2e-4
    assert all(v.shape == (2,) for v in stats.values())
    assert ("shadow_big_dropped" in stats) == (name == "config4")
    assert 0.05 < float(stats["covered_fraction"].min()) < 1.0
    for f, t in enumerate(thetas):
        fb, st = pipeline.render_frame(scene, dataclasses.replace(
            cam, theta=t), light, cfg, shadow_target=(0.0, 0.0, -1.0),
            device="cpu")
        assert torch.equal(rgba[f], fb), f
        assert all(torch.equal(stats[k][f], st[k]) for k in st)
        # The batch's gap to JAX is exactly the per-frame gap.
        fb_j, _ = j_pipe.render_frame(
            js, jcam.replace(theta=jnp.float32(t)), jl, jcfg,
            shadow_target=(0.0, 0.0, -1.0), backend="pallas")
        np.testing.assert_array_equal(
            np.abs(rgba[f].numpy() - rgba_j[f]),
            np.abs(fb.numpy() - np.asarray(fb_j)), err_msg=f"frame {f}")


@pytest.mark.parametrize("name", ["config1", "config4"])
def test_render_batch_takes_the_px_branch(name, monkeypatch):
    """Textured and directional-light scenes go to the px batch, with
    ``chunk`` None, "auto" and 1 giving the same frames."""
    scene, cam, light, cfg, thetas = _port_case(name)
    called = []
    fn = pipeline.render_frame_batch_px

    def spy(*a, **k):
        called.append("px")
        return fn(*a, **k)
    monkeypatch.setattr(pipeline, "render_frame_batch_px", spy)
    want = _port_px(name)[0]
    for chunk, n in ((None, 1), ("auto", 1), (1, 2)):
        called.clear()
        rgba, _ = render_batch(scene, cam, light, [0.0, 0.0], thetas,
                               config=cfg, chunk=chunk, device="cpu")
        assert called == ["px"] * n
        assert torch.equal(rgba, want)


def test_px_batch_takes_cameras_from_jax():
    """A stacked JAX camera pytree (leading frame axis, as the JAX
    ``render_batch(cameras=...)`` takes) carried across by
    ``convert.cameras_from_jax`` renders the frames the thetas give."""
    scene, cam, light, cfg, thetas = _port_case("config4")
    jcam = _jax_case("config4")[1]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *[
        jcam.replace(theta=jnp.float32(t)) for t in thetas])
    cams = convert.cameras_from_jax(stacked)
    assert len(cams) == 2
    for c, t in zip(cams, thetas):
        assert c == convert.camera_from_jax(jcam.replace(theta=t))
        assert torch.equal(c.view_matrix(), dataclasses.replace(
            cam, theta=t).view_matrix())
    rgba, stats = pipeline.render_frame_batch_px(
        scene, cam, light, cfg, ShadowConfig(), [0.0, 0.0], None,
        cameras=cams, device="cpu")
    want, want_stats = _port_px("config4")
    assert torch.equal(rgba, want)
    assert all(torch.equal(stats[k], want_stats[k]) for k in stats)


def test_config1_matches_jax_reference():
    """BASELINE config 1 (the checkerboard-textured cube, no shadow pass)
    through ``render_frame`` at 128x128 against the JAX reference."""
    w = h = 128
    scene, cam, light, cfg = configs.config1_textured_cube(w, h, device="cpu")
    fb, st = pipeline.render_frame(scene, cam, light, cfg, device="cpu")
    js, jcam, jl, jcfg = j_configs.config1_textured_cube()
    fb_j, st_j = j_render(js, jcam, jl, jcfg.replace(width=w, height=h),
                          backend="reference")
    assert fb.shape == (h, w, 4) and torch.isfinite(fb).all()
    assert _psnr(fb.numpy(), np.asarray(fb_j)) >= 40.0
    assert abs(float(st["covered_fraction"])
               - float(st_j["covered_fraction"])) <= 1e-6
    assert 0.05 < float(st["covered_fraction"]) < 1.0
    assert "shadow_big_dropped" not in st
    for k in ("num_triangles", "culled_triangles", "big_dropped"):
        assert int(st[k]) == int(st_j[k]), k


def _frame(tree, f):
    return jax.tree.map(lambda x: x[f], tree)


def test_raster_gbuffer_batch_plain_matches_pallas():
    """K5's twin on config 4's two frames (the JAX setups carried across
    frame by frame) against ``rasterize_tiles_batch``."""
    js, jcam, _, jcfg = _jax_case("config4")
    thetas = _port_case("config4")[4]
    prep = jax.jit(j_pipe.prepare_main_pass, static_argnums=(3,))
    geom = bake(js, 0.0)
    frames = [prep(geom, c.view_matrix(), c.projection_matrix(), jcfg)
              for c in (jcam.replace(theta=jnp.float32(t)) for t in thetas)]
    setup_b, pg_b = jax.tree.map(lambda *x: jnp.stack(x), *frames)
    gout_j, st_j = raster_pallas.rasterize_tiles_batch(setup_b, pg_b, W, H,
                                                       SAMPLES)
    gout_j = np.asarray(gout_j)
    bins = [binning.bin_triangles(
        convert.setup_from_jax(s), convert.tensor(jb.build_tri_fields(s)),
        W, H, 128, 8, attr_fields=binning.build_attr_fields(
            convert.setup_from_jax(s), convert.pass_geometry_from_jax(pg)))
        for s, pg in frames]
    bb = raster_cuda.stack_bins(bins)
    before = dict(raster_cuda.LAUNCHES)
    gout = raster_cuda.raster_gbuffer_batch(bb, W, H, SAMPLES)
    assert raster_cuda.LAUNCHES == before
    assert gout.shape == gout_j.shape == (2, 16, H, W)
    np.testing.assert_array_equal(bb.num_big_dropped.numpy(),
                                  np.asarray(st_j["big_dropped"]))
    cnt = gout[:, binning.ROW_DEPTH].numpy()
    np.testing.assert_array_equal(cnt, gout_j[:, binning.ROW_DEPTH])
    assert 0.3 < (cnt > 0).mean() < 1.0
    for f, (b, (s, pg), most) in enumerate(zip(bins, frames, (2174, 111))):
        _, _, win = raster_cuda.raster_gbuffer_plain(b, W, H, SAMPLES,
                                                     with_samples=True)
        np.testing.assert_array_equal(
            gout[f].numpy().view(np.int32),
            _numpy_gout(b, win, SAMPLES).view(np.int32))
        ref = _first_sample(_reference_gout(s, pg, win, SAMPLES, W, H), win)
        _near_pallas(gout[f].numpy()[:15], gout_j[f, :15], ref, most)
    assert not torch.equal(gout[0], gout[1])


@pytest.mark.parametrize("mode", [sampling.REPEAT, sampling.CLAMP])
def test_sample_bilinear_batch_plain_matches_pallas(mode):
    """K8's twin: three frames, each sampled from its own 64^2 map (the
    batch's shadow maps' size), with a mask and ``oob_value``."""
    rng = np.random.default_rng(5)
    F = 3
    tex = rng.uniform(size=(F, 64, 64)).astype(np.float32)
    u, v = rng.uniform(-0.5, 1.5, (2, F, 16, 128)).astype(np.float32)
    mask = rng.uniform(size=(F, 16, 128)) > 0.2
    t = [torch.from_numpy(x) for x in (tex, u, v, mask)]
    before = dict(sample_cuda.LAUNCHES)
    out = sample_cuda.sample_bilinear_batch(*t[:3], mode, 1.0, t[3])
    assert sample_cuda.LAUNCHES == before
    assert torch.equal(out, sample_cuda.sample_bilinear_batch_plain(
        *t[:3], mode, 1.0, t[3]))
    tiled = np.asarray(sample_pallas.sample_bilinear_tiled_batch(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), mode,
        oob_value=1.0, mask=jnp.asarray(mask)))
    out = out.numpy()
    for f in range(F):
        ref = np.asarray(j_sampling.sample_bilinear(
            jnp.asarray(tex[f])[..., None], jnp.asarray(u[f]),
            jnp.asarray(v[f]), mode)[..., 0])
        m = mask[f]
        np.testing.assert_allclose(out[f][m], ref[m], rtol=0, atol=1e-6)
        assert (out[f][~m] == 1.0).all()
        # Frame by frame, K8's twin is K7's.
        k7 = sample_cuda.sample_bilinear(t[0][f], t[1][f], t[2][f], mode,
                                         1.0, t[3][f])
        assert torch.equal(torch.from_numpy(out[f]), k7)
    np.testing.assert_allclose(out, tiled, rtol=0,
                               atol=float(np.spacing(np.float32(64))))
    with pytest.raises(ValueError, match="F, TH, TW"):
        sample_cuda.sample_bilinear_batch(t[0][0], *t[1:3], mode)


# Frame batches whose H*W is not a multiple of K8's 8-pixel units, so that
# frames start at every phase: (frames, H, W, coordinates).
K8_RAGGED = {"3x5x13_random": (3, 5, 13, "random"),
             "5x7x9_far": (5, 7, 9, "far"),
             "4x1x1_random": (4, 1, 1, "random")}


def k8_ragged_case(name, size=32, seed=9):
    """(tex f32[F, size, size], u, v f32[F, H, W], mask bool[F, H, W]),
    numpy, from a seed; ``far``: coordinates around +-37.25."""
    F, h, w, coords = K8_RAGGED[name]
    rng = np.random.default_rng(seed)
    tex = rng.uniform(size=(F, size, size)).astype(np.float32)
    u, v = rng.uniform(-0.5, 1.5, (2, F, h, w))
    if coords == "far":
        u, v = (rng.choice([-37.25, 37.25], (F, h, w)) + c for c in (u, v))
    mask = rng.uniform(size=(F, h, w)) > 0.3
    return tex, u.astype(np.float32), v.astype(np.float32), mask


@pytest.mark.parametrize("mode", [sampling.REPEAT, sampling.CLAMP])
@pytest.mark.parametrize("case", list(K8_RAGGED))
def test_sample_bilinear_batch_plain_matches_pallas_on_ragged_frames(case,
                                                                     mode):
    """K8's twin on frames whose H*W % 8 != 0 (also far outside [0, 1])
    against ``sample_bilinear_tiled_batch`` in interpret mode (one ulp of
    the texture width), exact bilinear sampling frame by frame (1e-6), and
    K7's twin frame by frame (bit-equal)."""
    tex, u, v, mask = k8_ragged_case(case)
    t = [torch.from_numpy(x) for x in (tex, u, v, mask)]
    out = sample_cuda.sample_bilinear_batch(*t[:3], mode, 1.0, t[3]).numpy()
    tiled = np.asarray(sample_pallas.sample_bilinear_tiled_batch(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), mode,
        oob_value=1.0, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(out, tiled, rtol=0,
                               atol=float(np.spacing(np.float32(32))))
    for f in range(tex.shape[0]):
        ref = np.asarray(j_sampling.sample_bilinear(
            jnp.asarray(tex[f])[..., None], jnp.asarray(u[f]),
            jnp.asarray(v[f]), mode)[..., 0])
        np.testing.assert_allclose(out[f], np.where(mask[f], ref, 1.0),
                                   rtol=0, atol=1e-6)
        k7 = sample_cuda.sample_bilinear(t[0][f], t[1][f], t[2][f], mode,
                                         1.0, t[3][f])
        assert torch.equal(torch.from_numpy(out[f]), k7)


def test_shadow_pass_bins_with_the_default_span_cap():
    """The shadow pass bins with span cap 8, as every JAX shadow pass does,
    whatever ``config.span_cap`` says (the main pass keeps it): at
    ``span_cap=2`` the port's shadow big list is JAX's at 8, not at 2."""
    size = 256
    cfg = RenderConfig(width=64, height=32, shadow_map_size=size,
                       span_cap=2)
    scene = audio_app.build_scene(device="cpu")
    cam = _port_case("config4")[1]
    prep = pipeline.prepare_frame(scene, cam, Lighting.default(), cfg,
                                  shadow_target=(0.0, 0.0, -1.0),
                                  device="cpu")

    @functools.partial(jax.jit, static_argnums=0)
    def big_n(cap):
        lv = j_lights.light_view_matrix(jnp.array([0.0, 2.0, 0.0]),
                                        jnp.array([0.0, 0.0, -1.0]))
        geom = bake(j_app.build_scene(), 0.0)
        clip2, _, parent = clip_near(project(
            geom.world, lv, j_lights.light_projection_matrix()).reshape(
                -1, 3, 4))
        s = setup_triangles(clip2, size, size, cull_backfaces=False)
        s = s.replace(valid=s.valid & geom.cast_shadow[parent])
        return jb.bin_triangles(s, jb.build_tri_fields(s), size, size, 128,
                                64, span_cap=cap).big_n[0]
    assert int(big_n(2)) != int(big_n(8))      # the cap matters here
    assert int(prep.shadow_bins.big_n[0]) == int(big_n(8))
    assert prep.shadow_bins.tile_tris.shape[0] == \
        prep.shadow_bins.vis.shape[0] * frame_prep.SHADOW_SPAN_CAP
    assert prep.main_bins.tile_tris.shape[0] == \
        prep.main_bins.vis.shape[0] * 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_px_kernels_match_twins_on_card(cuda_device):
    """K5 and K8 bit-equal to their twins and to per-frame K3 and K7
    launches, on config 4's batch prep."""
    scene, cam, light, cfg, thetas = _port_case("config4")
    preps = [pipeline.prepare_frame(scene, dataclasses.replace(cam, theta=t),
                                    light, cfg, device=cuda_device)
             for t in thetas]
    mb = raster_cuda.stack_bins([p.main_bins for p in preps])
    g_k = raster_cuda.raster_gbuffer_batch(mb, W, H, SAMPLES)
    g_p = raster_cuda.raster_gbuffer_batch_plain(mb, W, H, SAMPLES)
    rng = np.random.default_rng(5)
    tex, u, v = (torch.from_numpy(rng.uniform(-0.5, 1.5, s).astype(
        np.float32)).to(cuda_device) for s in ((2, 64, 64), (2, H, W),
                                                (2, H, W)))
    mask = g_k[:, binning.ROW_DEPTH] > 0
    s_k = sample_cuda.sample_bilinear_batch(tex, u, v, sampling.REPEAT, 1.0,
                                            mask)
    s_p = sample_cuda.sample_bilinear_batch_plain(tex, u, v, sampling.REPEAT,
                                                  1.0, mask)
    torch.cuda.synchronize()
    assert torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
    assert torch.equal(s_k, s_p)
    for f, p in enumerate(preps):
        g3 = raster_cuda.raster_gbuffer(p.main_bins, W, H, SAMPLES)[0]
        s7 = sample_cuda.sample_bilinear(tex[f], u[f], v[f], sampling.REPEAT,
                                         1.0, mask[f].contiguous())
        assert torch.equal(g3, g_k[f]) and torch.equal(s7, s_k[f])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [sampling.REPEAT, sampling.CLAMP])
@pytest.mark.parametrize("case", list(K8_RAGGED))
def test_sample_bilinear_batch_on_ragged_frames_on_card(cuda_device, case,
                                                        mode):
    """K8 bit-equal to its twin and, frame by frame, to K7 on frames whose
    H*W % 8 != 0 (each frame's planes start at another phase), with and
    without a mask."""
    tex, u, v, mask = (torch.from_numpy(x).to(cuda_device)
                       for x in k8_ragged_case(case))
    for m in (mask, None):
        k = sample_cuda.sample_bilinear_batch(tex, u, v, mode, 1.0, m)
        p = sample_cuda.sample_bilinear_batch_plain(tex, u, v, mode, 1.0, m)
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
        for f in range(tex.shape[0]):
            k7 = sample_cuda.sample_bilinear(tex[f], u[f], v[f], mode, 1.0,
                                             None if m is None else m[f])
            assert torch.equal(k7.view(torch.int32), k[f].view(torch.int32))
