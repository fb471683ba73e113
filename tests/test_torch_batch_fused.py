"""Port parity, the frame-batch API's fused branch:
``render_frame_batch_fused`` (K4 shadow maps + K6, run by their plain twins
on the CPU) against the JAX ``render_frame_batch_fused`` in interpret mode,
on the JAX package's own batch case (tests/test_fused_batch.py: 128x64
MSAA4, 64^2 shadow map, displacements 0 / 0.35 / 5.0 — the last
near-clips heavily — and thetas 2.5 / 2.8 / 2.2); the hoisted and chunked
shapes, ``render_batch``'s dispatch, per-frame scene and lighting, and the
K4 and K6 twins against ``rasterize_depth_batch`` and
``render_fused_batch``.

Tolerances, with their reasons:
  * covered fractions within 1e-6 (the same counts, averaged in another
    order) and ``big_dropped`` equal per frame;
  * whole batches against JAX: rgba >= 60 dB PSNR and max abs error <=
    5e-3. Measured: 2.53e-3 on 147 of 8192 pixels of frame 0, 1.58e-5 on
    629 pixels of frame 1, 1.8e-6 on frame 2 — pixel for pixel the
    difference between the port's and the JAX package's own per-frame
    ``render_frame`` (``backend="pallas"``), which the test asserts. It
    comes from the prep, not the kernels: torch and
    XLA:CPU round the same camera's view matrix 4.8e-7 apart, and the
    near- and guard-band-clipped floor triangles magnify that (ROADMAP
    C6: XLA:CPU contracts multiply-adds into FMAs);
  * the kernel alone, K6's twin against ``render_fused_batch`` on the same
    converted setups: rgba within 1e-5 (the port's shadow lookup is exact
    where the Pallas kernel's falls back to "lit" outside its DMA window,
    ROADMAP C1; C6), covered fractions equal;
  * every batch frame BIT-EQUAL to the port's own ``render_frame`` of that
    frame: the batch kernels run the per-frame kernels' code on each
    frame's bins;
  * K4 depth bit-equal to a numpy evaluation that rounds every step, within
    1e-6 of the interpret-mode kernel (C6); winners equal;
  * the shadow pass asks K1/K4 for depth alone: its shadow maps bit-equal
    to the winner-carrying form's depth.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.config import ShadowConfig as JShadow
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.passes import pipeline as j_pipe
from metalrenderer_tpu.raster import binning as jb, raster_pallas
from metalrenderer_tpu.raster.geometry import clip_near, setup_triangles
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.scene import bake, project

from test_torch_raster import _numpy_anchored_depth, _small_soup, _to

from metalrenderer_tpu_torch import convert, render_batch
from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import binning, raster_cuda
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight

torch.set_num_threads(2)
W, H = 128, 64
DISPS = [0.0, 0.35, 5.0]
THETAS = [2.5, 2.8, 2.2]
TARGET = (0.0, 0.0, -1.0)          # the batch API's default shadow target
CFG = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=64)
JCFG = JConfig(width=W, height=H, msaa=4, shadow_map_size=64)
CAM = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=2.0)
JCAM = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=2.0)
# Per-frame light colors (the audio-reactive shape).
COLORS = [(1.0, 1.0, 1.0), (1.0, 0.4, 0.2), (0.3, 0.6, 1.0)]


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def _scene():
    return audio_app.build_scene(device="cpu")


def _per_frame(disps=DISPS, thetas=THETAS, scenes=None, lightings=None):
    """The port's render_frame of each frame of a batch."""
    n = len(disps)
    scenes = scenes or [_scene()] * n
    lightings = lightings or [Lighting.default()] * n
    return [pipeline.render_frame(sc, dataclasses.replace(CAM, theta=t), lt,
                                  CFG, displacement=d, shadow_target=TARGET,
                                  device="cpu")
            for d, t, sc, lt in zip(disps, thetas, scenes, lightings)]


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _assert_matches_jax(rgba, stats, rgba_j, stats_j):
    rgba_j = np.asarray(rgba_j)
    assert rgba.shape == rgba_j.shape
    np.testing.assert_allclose(stats["covered_fraction"].numpy(),
                               np.asarray(stats_j["covered_fraction"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(stats["big_dropped"].numpy(),
                                  np.asarray(stats_j["big_dropped"]))
    for f in range(rgba.shape[0]):
        assert _psnr(rgba[f].numpy(), rgba_j[f]) >= 60.0, f
    assert float(np.abs(rgba.numpy() - rgba_j).max()) <= 5e-3


def _assert_gap_is_render_frames(rgba, rgba_j, frames, frames_j):
    """Per pixel, |batch - JAX batch| equals |port render_frame - JAX
    render_frame| of the same frame: the batch adds no error of its own."""
    rgba_j = np.asarray(rgba_j)
    for f, (fb, fb_j) in enumerate(zip(frames, frames_j)):
        np.testing.assert_array_equal(
            np.abs(rgba[f].numpy() - rgba_j[f]),
            np.abs(fb.numpy() - np.asarray(fb_j)), err_msg=f"frame {f}")


def _assert_bit_equal_per_frame(rgba, frames):
    assert rgba.shape[0] == len(frames)
    for i, (fb, st) in enumerate(frames):
        assert torch.equal(rgba[i], fb), f"frame {i}"


@functools.cache
def _port_fused():
    return pipeline.render_frame_batch_fused(
        _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), DISPS,
        THETAS, device="cpu")


def test_fused_batch_matches_jax_and_render_frame():
    before = dict(raster_cuda.LAUNCHES)
    rgba, stats = _port_fused()
    assert raster_cuda.LAUNCHES == before          # CPU: the twins ran
    rgba_j, stats_j = j_pipe.render_frame_batch_fused(
        j_app.build_scene(), JCAM, j_lights.Lighting.default(), JCFG,
        JShadow(), _f32(DISPS), _f32(THETAS))
    _assert_matches_jax(rgba, stats, rgba_j, stats_j)
    # Per-frame leaves, the shadow pass's overflow count included (the JAX
    # batch drops it, ROADMAP C2).
    for k in ("big_dropped", "shadow_big_dropped", "covered_fraction",
              "shadow_min_depth"):
        assert stats[k].shape == (3,), k
    assert float(stats["covered_fraction"][2]) == 1.0   # the near-clip frame
    frames = _per_frame()
    _assert_bit_equal_per_frame(rgba, frames)
    for k, v in frames[0][1].items():
        np.testing.assert_allclose(
            stats[k].numpy(), [float(st[k]) for _, st in frames], rtol=0,
            atol=1e-6, err_msg=k)
    # The batch's gap to JAX is exactly the two packages' per-frame gap.
    _assert_gap_is_render_frames(rgba, rgba_j, [fb for fb, _ in frames], [
        j_pipe.render_frame(j_app.build_scene(), JCAM.replace(theta=t),
                            j_lights.Lighting.default(), JCFG,
                            displacement=d, shadow_target=TARGET,
                            backend="pallas")[0]
        for d, t in zip(DISPS, THETAS)])


def test_fused_batch_per_frame_scene_and_lighting():
    """``scene_fn``/``lighting_fn`` with ``frame_params`` (per-frame light
    color, the emissive cube following it) against JAX with the same
    params, and bit-equal to render_frame with each frame's scene and
    lighting."""
    def j_lighting(c):
        return j_lights.Lighting(light=j_lights.PointLight(color=c))

    rgba_j, stats_j = j_pipe.render_frame_batch_fused(
        j_app.build_scene(), JCAM, j_lights.Lighting.default(), JCFG,
        JShadow(), _f32(DISPS), _f32(THETAS),
        scene_fn=lambda c: j_app.build_scene(light_color=c),
        lighting_fn=j_lighting, frame_params=_f32(COLORS))

    def scene_fn(c):
        return audio_app.build_scene(light_color=c, device="cpu")

    def lighting_fn(c):
        return Lighting(light=PointLight(color=c))

    rgba, stats = pipeline.render_frame_batch_fused(
        _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), DISPS,
        THETAS, scene_fn=scene_fn, lighting_fn=lighting_fn,
        frame_params=COLORS, device="cpu")
    _assert_matches_jax(rgba, stats, rgba_j, stats_j)
    _assert_bit_equal_per_frame(rgba, _per_frame(
        scenes=[scene_fn(c) for c in COLORS],
        lightings=[lighting_fn(c) for c in COLORS]))
    # The colors reach the frames: frame 1 differs from the white-light one.
    assert not torch.equal(rgba[1], _port_fused()[0][1])


def test_hoisted_batch_matches_fused():
    """Prep for all frames, then K1 + K2 per frame: the same frames as the
    fold; ``frame_map`` is applied to each frame."""
    rgba_f, stats_f = _port_fused()
    rgba, stats = pipeline.render_frame_batch_hoisted(
        _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), DISPS,
        THETAS, device="cpu")
    assert torch.equal(rgba, rgba_f)
    assert set(stats) == set(stats_f)
    for k in stats:
        assert stats[k].shape == (3,), k

    def frame_map(r):
        return r.mean(dim=(0, 1))

    means, _ = pipeline.render_frame_batch_hoisted(
        _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), DISPS,
        THETAS, frame_map=frame_map, device="cpu")
    assert torch.equal(means, torch.stack([frame_map(r) for r in rgba_f]))


def test_render_batch_chunks_give_the_same_frames():
    """``chunk`` None, "auto" and 2 give bit-equal frames, and
    ``render_frame_batch_chunked(frame_map=...)`` equals the map applied to
    each sub-batch of the whole batch."""
    disps = [0.0, 0.1, 0.35, 5.0]
    thetas = [2.5, 2.6, 2.8, 2.2]
    outs = [render_batch(_scene(), CAM, Lighting.default(), disps, thetas,
                         config=CFG, chunk=c, device="cpu")
            for c in (None, "auto", 2)]
    for rgba, stats in outs[1:]:
        assert torch.equal(rgba, outs[0][0])
        assert all(torch.equal(stats[k], outs[0][1][k]) for k in stats)
    _assert_bit_equal_per_frame(outs[0][0], _per_frame(disps, thetas))

    def frame_map(r):
        return r.mean(dim=(1, 2))

    means, stats = pipeline.render_frame_batch_chunked(
        _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), disps,
        thetas, chunk=2, frame_map=frame_map, device="cpu")
    rgba = outs[0][0]
    assert torch.equal(means, torch.stack([frame_map(rgba[:2]),
                                           frame_map(rgba[2:])]))
    assert stats["covered_fraction"].shape == (4,)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.render_frame_batch_chunked(
            _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), disps,
            thetas, chunk=3, device="cpu")


def _record_calls(monkeypatch):
    called = []
    for name in ("render_frame_batch_fused", "render_frame_batch_px",
                 "render_frame_batch_chunked", "render_frame"):
        fn = getattr(pipeline, name)

        def spy(*a, _fn=fn, _name=name, **k):
            called.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(pipeline, name, spy)
    return called


@pytest.mark.parametrize("case", ["flagship", "tiles", "per_sample",
                                  "reference"])
def test_render_batch_dispatch(case, monkeypatch):
    """The flagship takes the fused batch (matching the JAX render_batch
    within the fused-batch tolerances); configurations no batch branch
    takes go frame by frame through render_frame: 16x128 tiles and
    supersampled shading (the per-sample G-buffer) render, each frame
    bit-equal to render_frame of that frame; the reference backend also
    goes frame by frame, its frames bit-equal to render_frame's on the
    reference backend."""
    called = _record_calls(monkeypatch)
    disps = DISPS[:2]
    if case == "flagship":
        rgba, stats = render_batch(_scene(), CAM, Lighting.default(), disps,
                                   config=CFG, device="cpu")
        assert called == ["render_frame_batch_fused"]
        rgba_j, stats_j = j_pipe.render_batch(
            j_app.build_scene(), JCAM, j_lights.Lighting.default(),
            _f32(disps), config=JCFG)
        _assert_matches_jax(rgba, stats, rgba_j, stats_j)
        return
    if case == "reference":
        rgba, stats = render_batch(_scene(), CAM, Lighting.default(), disps,
                                   config=CFG, backend="reference",
                                   device="cpu")
        assert called == ["render_frame"] * 2
        for i, d in enumerate(disps):
            fb, st = pipeline.render_frame(
                _scene(), CAM, Lighting.default(), CFG, ShadowConfig(), d,
                (0.0, 0.0, -1.0), "reference", "cpu")
            assert torch.equal(rgba[i], fb)
            assert torch.equal(stats["covered_fraction"][i],
                               st["covered_fraction"])
        return
    cfg = (CFG.replace(tile_h=16) if case == "tiles"
           else CFG.replace(shading_per_pixel=False))
    for fn in (pipeline.render_frame_batch_fused,
               pipeline.render_frame_batch_px):
        with pytest.raises(ValueError, match="8x128"):
            fn(_scene(), CAM, Lighting.default(), cfg, ShadowConfig(), disps,
               THETAS[:2], device="cpu")
    del called[:]
    rgba, stats = render_batch(_scene(), CAM, Lighting.default(), disps,
                               THETAS[:2], config=cfg, device="cpu")
    assert called == ["render_frame"] * 2
    assert rgba.shape == (2, H, W, 4)
    assert stats["covered_fraction"].shape == (2,)
    for f, (d, t) in enumerate(zip(disps, THETAS)):
        fb, st = pipeline.render_frame(
            _scene(), dataclasses.replace(CAM, theta=t), Lighting.default(),
            cfg, displacement=d, shadow_target=TARGET, device="cpu")
        assert torch.equal(fb, rgba[f])
        assert torch.equal(st["covered_fraction"],
                           stats["covered_fraction"][f])


def test_batch_entry_points_default_to_the_card():
    """With no ``device`` every batch entry point renders on the GPU:
    without one it raises rather than fall back to the CPU."""
    scene, lt, args = _scene(), Lighting.default(), (DISPS[:2], THETAS[:2])
    calls = (
        lambda: render_batch(scene, CAM, lt, DISPS[:2], config=CFG),
        lambda: pipeline.render_frame_batch_fused(scene, CAM, lt, CFG,
                                                  ShadowConfig(), *args),
        lambda: pipeline.render_frame_batch_px(scene, CAM, lt, CFG,
                                               ShadowConfig(), *args),
        lambda: pipeline.render_frame_batch_hoisted(scene, CAM, lt, CFG,
                                                    ShadowConfig(), *args),
        lambda: pipeline.render_frame_batch_chunked(
            scene, CAM, lt, CFG, ShadowConfig(), *args, chunk=1))
    for call in calls:
        if torch.cuda.is_available():
            assert call()[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def test_stack_bins_validates():
    """Frames of one batch must share the tile grid and table shapes."""
    p = [pipeline.prepare_frame(_scene(), CAM, Lighting.default(), CFG,
                                displacement=d, shadow_target=TARGET,
                                device="cpu") for d in DISPS[:2]]
    bb = raster_cuda.stack_bins([q.main_bins for q in p])
    assert raster_cuda.is_batch(bb) and bb.vis.shape[0] == 2
    assert not raster_cuda.is_batch(p[0].main_bins)
    assert bb.big_n.shape == (2,) and bb.num_big_dropped.shape == (2,)
    assert bb.tile_tris.shape[0] == 2 and bb.attr.shape[0] == 2
    with pytest.raises(ValueError, match="frame batch"):
        raster_cuda.raster_gbuffer_batch(p[0].main_bins, W, H, ((0.5, 0.5),))
    for f in range(2):
        one = raster_cuda.frame_bins(bb, f)
        for k in ("vis", "attr", "tile_offsets", "tile_tris", "big_ids",
                  "big_aabb", "big_n", "num_big_dropped"):
            assert torch.equal(getattr(one, k), getattr(p[f].main_bins, k))
    with pytest.raises(ValueError, match="tile grids"):
        raster_cuda.stack_bins([p[0].main_bins, p[0].shadow_bins])
    with pytest.raises(ValueError, match="attr"):
        raster_cuda.stack_bins([p[0].main_bins, dataclasses.replace(
            p[1].main_bins, attr=None)])
    with pytest.raises(ValueError, match="tile_tris"):
        raster_cuda.stack_bins([p[0].main_bins, dataclasses.replace(
            p[1].main_bins, tile_tris=p[1].main_bins.tile_tris[:-8])])
    with pytest.raises(ValueError, match="no frames"):
        raster_cuda.stack_bins([])


@functools.cache
def _jax_batch_prep(size):
    """The JAX package's per-frame prep of the batch, vmapped as its
    ``render_frame_batch_fused`` does: shadow setups at ``size``^2, main
    setups, pass geometry and fused uniforms, each with a frame axis."""
    anchor = jnp.array([0.0, 2.0, 0.0])
    lv = j_lights.light_view_matrix(anchor, jnp.array(TARGET))
    lp = j_lights.light_projection_matrix()
    lighting = j_lights.Lighting.default()

    def one(disp, theta):
        geom = bake(j_app.build_scene(), disp)
        clip2, _, parent = clip_near(
            project(geom.world, lv, lp).reshape(-1, 3, 4))
        s = setup_triangles(clip2, size, size, cull_backfaces=False)
        cam = JCAM.replace(theta=theta)
        setup, pg = j_pipe.prepare_main_pass(
            geom, cam.view_matrix(), cam.projection_matrix(), JCFG)
        funi = j_pipe._fused_uniforms(jnp.dot(lp, lv, precision="highest"),
                                      cam, anchor, lighting.light, lighting,
                                      JCFG)
        return s.replace(valid=s.valid & geom.cast_shadow[parent]), setup, \
            pg, funi
    return jax.jit(jax.vmap(one))(_f32(DISPS), _f32(THETAS))


def _frame(tree, f):
    return jax.tree.map(lambda x: x[f], tree)


def test_raster_depth_batch_plain_matches_pallas():
    """K4's twin on the three frames' 128^2 shadow passes (the JAX setups
    carried across frame by frame) against ``rasterize_depth_batch``."""
    size = 128
    setup_b = _jax_batch_prep(size)[0]
    depth_j = np.asarray(raster_pallas.rasterize_depth_batch(
        setup_b, size, 64, 128))
    frames = [_frame(setup_b, f) for f in range(3)]
    bins = raster_cuda.stack_bins([
        binning.bin_triangles(convert.setup_from_jax(s),
                              convert.tensor(jb.build_tri_fields(s)), size,
                              size, 128, 64) for s in frames])
    before = dict(raster_cuda.LAUNCHES)
    d_p, w_p = raster_cuda.raster_depth_batch(bins, size, size, ((0.5, 0.5),))
    assert raster_cuda.LAUNCHES == before
    assert d_p.shape == (3, 1, size, size)
    np.testing.assert_allclose(d_p[:, 0].numpy(), depth_j, rtol=0, atol=1e-6)
    for f, s in enumerate(frames):
        _, w_j, _, _ = raster_pallas.rasterize_tiles(s, size, size, 64, 128,
                                                     ((0.5, 0.5),))
        np.testing.assert_array_equal(w_p[f].numpy(), np.asarray(w_j))
        z_np, _ = _numpy_anchored_depth(bins.vis[f], size, size, 64, 128)
        np.testing.assert_array_equal(d_p[f, 0].numpy().view(np.int32),
                                      z_np.view(np.int32))
    assert (w_p[2] >= 0).any() and not torch.equal(d_p[0], d_p[2])


def test_render_fused_batch_plain_matches_pallas():
    """K6's twin against ``render_fused_batch`` on the same converted JAX
    setups, uniforms and (JAX) shadow maps: only the kernels differ."""
    setup_l, setup_b, pg_b, funi_b = _jax_batch_prep(64)
    smaps = raster_pallas.rasterize_depth_batch(setup_l, 64, 64, 128)
    samples = tuple(JCFG.sample_positions)
    rgba_j, covf_j, st_j = raster_pallas.render_fused_batch(
        setup_b, pg_b, funi_b, W, H, samples, shadow_map_b=smaps)
    bins = []
    for f in range(3):
        s, pg = _frame(setup_b, f), _frame(pg_b, f)
        bins.append(binning.bin_triangles(
            convert.setup_from_jax(s), convert.tensor(jb.build_tri_fields(s)),
            W, H, 128, 8, attr_fields=binning.build_attr_fields(
                convert.setup_from_jax(s),
                convert.pass_geometry_from_jax(pg))))
    bb = raster_cuda.stack_bins(bins)
    before = dict(raster_cuda.LAUNCHES)
    rgba_p, covf_p = raster_cuda.render_fused_batch(
        bb, convert.tensor(funi_b), convert.tensor(smaps), W, H, samples)
    assert raster_cuda.LAUNCHES == before
    assert rgba_p.shape == (3, H, W, 4)
    np.testing.assert_array_equal(covf_p.numpy(), np.asarray(covf_j))
    np.testing.assert_array_equal(bb.num_big_dropped.numpy(),
                                  np.asarray(st_j["big_dropped"]))
    diff = np.abs(rgba_p.numpy() - np.asarray(rgba_j)).max(axis=-1)
    assert int((diff > 1e-5).sum()) == 0, float(diff.max())
    assert float(covf_p[2].mean()) == 1.0 and float(covf_p[0].mean()) < 1.0


@pytest.mark.parametrize("batch", [False, True], ids=["frame", "batch"])
def test_shadow_pass_asks_for_depth_alone(batch, monkeypatch):
    """``_shadow_pass`` launches K1 (one frame) or K4 (a batch) with no
    winner plane, and its shadow map and ``shadow_min_depth`` are those of
    the winner-carrying form: bit-equal."""
    preps = [pipeline.prepare_frame(_scene(), dataclasses.replace(
        CAM, theta=t), Lighting.default(), CFG, displacement=d,
        shadow_target=TARGET, device="cpu") for d, t in zip(DISPS, THETAS)]
    if batch:
        bins = raster_cuda.stack_bins([p.shadow_bins for p in preps])
        ref = raster_cuda.raster_depth_batch_plain(
            bins, 64, 64, ((0.5, 0.5),))[0][:, 0]
    else:
        bins = preps[0].shadow_bins
        ref = raster_cuda.raster_depth_plain(bins, 64, 64,
                                             ((0.5, 0.5),))[0][0]
    asked = []
    for name in ("raster_depth", "raster_depth_batch"):
        def spy(*args, _fn=getattr(raster_cuda, name), _name=name, **kw):
            asked.append((_name, kw.get("with_winner", True)))
            return _fn(*args, **kw)
        monkeypatch.setattr(raster_cuda, name, spy)
    stats = {}
    smap = pipeline._shadow_pass(bins, CFG, stats)
    assert asked == [("raster_depth_batch" if batch else "raster_depth",
                      False)]
    assert bool((ref < 1.0).any())
    assert smap.shape == ref.shape
    assert torch.equal(smap.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(stats["shadow_min_depth"],
                       torch.amin(ref, dim=(-2, -1)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batch_kernels_match_twins_on_card(cuda_device):
    """K4 and K6 bit-equal / within 1e-5 of their twins, and bit-equal to
    per-frame K1 and K2 launches, on the batch's own prep."""
    preps = [pipeline.prepare_frame(_scene(), dataclasses.replace(
        CAM, theta=t), Lighting.default(), CFG, displacement=d,
        shadow_target=TARGET, device=cuda_device)
        for d, t in zip(DISPS, THETAS)]
    sb = raster_cuda.stack_bins([p.shadow_bins for p in preps])
    mb = raster_cuda.stack_bins([p.main_bins for p in preps])
    center = ((0.5, 0.5),)
    d_k, w_k = raster_cuda.raster_depth_batch(sb, 64, 64, center)
    d_p, w_p = raster_cuda.raster_depth_batch_plain(sb, 64, 64, center)
    uni = torch.stack([p.uniforms for p in preps])
    samples = tuple(CFG.sample_positions)
    r_k, c_k = raster_cuda.render_fused_batch(mb, uni, d_k[:, 0], W, H,
                                              samples)
    r_p, c_p = raster_cuda.render_fused_batch_plain(mb, uni, d_k[:, 0], W, H,
                                                    samples)
    torch.cuda.synchronize()
    assert torch.equal(w_k, w_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(c_k, c_p)
    assert float((r_k - r_p).abs().max()) <= 1e-5
    for f, p in enumerate(preps):
        d1, _ = raster_cuda.raster_depth(p.shadow_bins, 64, 64, center)
        r2, _ = raster_cuda.render_fused(p.main_bins, p.uniforms, d1[0], W,
                                         H, samples)
        assert torch.equal(d1, d_k[f]) and torch.equal(r2, r_k[f])
    # K4 on a 2-frame batch of crowded soups (tile lists longer than one
    # staging chunk) on the shadow pass's 64x128 tiles, with and without the
    # winner plane: bit-equal to its twin and to per-frame K1 launches.
    soups = [_to(_small_soup(128, 64, 320, 240, seed=seed), cuda_device)
             for seed in (11, 12)]
    sb2 = raster_cuda.stack_bins(soups)
    d_k, w_k = raster_cuda.raster_depth_batch(sb2, 320, 240, center)
    d_n, w_n = raster_cuda.raster_depth_batch(sb2, 320, 240, center,
                                              with_winner=False)
    d_p, w_p = raster_cuda.raster_depth_batch_plain(sb2, 320, 240, center)
    per_frame = [raster_cuda.raster_depth(b, 320, 240, center) for b in soups]
    torch.cuda.synchronize()
    assert torch.equal(w_k, w_p) and w_n is None
    for d in (d_n, d_p, torch.stack([d1 for d1, _ in per_frame])):
        assert torch.equal(d_k.view(torch.int32), d.view(torch.int32))
    assert torch.equal(w_k, torch.stack([w1 for _, w1 in per_frame]))
