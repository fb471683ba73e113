"""Port parity, the whole frame: the port's render paths (run by the
kernels' plain twins on the CPU) against the JAX ``backend="reference"``
oracle and the committed goldens — the flagship AudioApp frame (shadow pass
+ fused main pass), and the split path (shadow pass + G-buffer raster +
deferred shading with textures, normal maps and a directional light):
BASELINE config 4, the grass-textured cube, the flagship with
``fused_shade=False``.

Bars: >= 60 dB PSNR against the JAX reference at 96x72 for the flagship —
the bar tests/test_raster_pallas.py:88 holds the Pallas kernels to — with
equal integer stats and float stats within 1e-6; >= 40 dB (the BASELINE.md
bar) for the split path against the JAX reference, with covered fractions
within 1e-6 (the reference averages per-sample coverage in another order),
and for every frame against the goldens (8-bit PNGs).
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import metalrenderer_tpu as mr
from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.lights import DirectionalLight as JDirectional
from metalrenderer_tpu.scene.lights import Lighting as JLighting

from benchmarks import configs as j_configs

from metalrenderer_tpu_torch import (DirectionalLight, Lighting, PointLight,
                                     convert)
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app, configs
from metalrenderer_tpu_torch.io import png
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import raster_cuda
from metalrenderer_tpu_torch.scene.camera import OrbitCamera

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens"


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("msaa", [4, 1])
def test_flagship_frame_matches_jax_reference(msaa):
    w, h = 96, 72
    jcam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
    fb_j, st_j = j_app.render_audio_app(
        displacement=0.02, camera=jcam, backend="reference",
        config=JConfig(width=w, height=h, msaa=msaa, shadow_map_size=128))
    before = dict(raster_cuda.LAUNCHES)
    fb_p, st_p = audio_app.render_audio_app(
        displacement=0.02, camera=convert.camera_from_jax(jcam),
        config=RenderConfig(width=w, height=h, msaa=msaa, shadow_map_size=128),
        device="cpu")
    assert raster_cuda.LAUNCHES == before       # CPU: the twins ran
    assert fb_p.shape == (h, w, 4) and fb_p.dtype == torch.float32
    psnr = _psnr(fb_p.numpy(), np.asarray(fb_j))
    assert psnr >= 60.0, psnr
    assert set(st_p) == set(st_j)
    for k in st_j:
        ref = np.asarray(st_j[k])
        if np.issubdtype(ref.dtype, np.integer):
            assert int(st_p[k]) == int(ref), k
        else:
            np.testing.assert_allclose(float(st_p[k]), float(ref),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_converted_jax_inputs_render_the_same_frame():
    """The JAX scene, camera and lighting carried across by ``convert``
    render bit-identically to the port's own flagship builders."""
    cfg = RenderConfig(width=64, height=48, msaa=4, shadow_map_size=128)
    jcam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=64 / 48)
    fb_c, st_c = pipeline.render_frame(
        convert.scene_from_jax(j_app.build_scene()),
        convert.camera_from_jax(jcam),
        convert.lighting_from_jax(JLighting.default()), cfg,
        displacement=0.01, shadow_target=(0.0, 0.0, -1.0), device="cpu")
    fb_p, st_p = audio_app.render_audio_app(
        displacement=0.01, camera=convert.camera_from_jax(jcam), config=cfg,
        device="cpu")
    assert torch.equal(fb_c, fb_p)
    assert all(torch.equal(st_c[k], st_p[k]) for k in st_p)


@pytest.mark.parametrize("size", [(160, 120, 256), (320, 240, 512)])
def test_flagship_frame_matches_golden(size):
    w, h, shadow = size
    golden = png.read_png(GOLDENS / f"audio_app_{w}x{h}.png")
    fb, stats = audio_app.render_audio_app(
        camera=OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h),
        config=RenderConfig(width=w, height=h, msaa=4, shadow_map_size=shadow),
        device="cpu")
    assert int(stats["big_dropped"]) == 0
    assert _psnr(fb.numpy()[..., :3], golden.astype(np.float32) / 255.0) >= 40.0


def test_port_imports_without_jax():
    code = ("import sys, metalrenderer_tpu_torch, "
            "metalrenderer_tpu_torch.engine.audio_app, "
            "metalrenderer_tpu_torch.engine.configs, "
            "metalrenderer_tpu_torch.passes.pipeline, "
            "metalrenderer_tpu_torch.engine.renderer, "
            "metalrenderer_tpu_torch.audio.analyzer, "
            "metalrenderer_tpu_torch.audio.interpreter, "
            "metalrenderer_tpu_torch.audio.mapping, "
            "metalrenderer_tpu_torch.io.wav, "
            "metalrenderer_tpu_torch.io.obj, "
            "metalrenderer_tpu_torch.io.native, "
            "metalrenderer_tpu_torch.convert, "
            "metalrenderer_tpu_torch.cli, "
            "metalrenderer_tpu_torch.engine.session, "
            "metalrenderer_tpu_torch.math.quaternion, "
            "metalrenderer_tpu_torch.utils.stats, "
            "metalrenderer_tpu_torch.utils.dashboard, "
            "metalrenderer_tpu_torch.utils.checkpoint, "
            "metalrenderer_tpu_torch.utils.profiling, "
            "metalrenderer_tpu_torch.raster.reference_cpu, "
            "metalrenderer_tpu_torch.passes.prep, "
            "metalrenderer_tpu_torch.parallel.sharding; "
            "from metalrenderer_tpu_torch import render, PoseCamera; "
            "from metalrenderer_tpu_torch.engine.renderer import ("
            "render_camera_path); "
            "from metalrenderer_tpu_torch import uv_sphere, square, triangle; "
            "from metalrenderer_tpu_torch.engine.configs import ("
            "config2_multi_mesh, config3_high_poly, "
            "config5_animated_high_poly); "
            "from metalrenderer_tpu_torch import render_batch; "
            "from metalrenderer_tpu_torch.passes.pipeline import ("
            "render_frame_batch_fused, render_frame_batch_px, "
            "render_frame_batch_hoisted, render_frame_batch_chunked); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'metalrenderer_tpu.')) or m == "
            "'metalrenderer_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = RenderConfig(width=32, height=32, shadow_map_size=64)
    with pytest.raises(RuntimeError, match="cuda"):
        audio_app.render_audio_app(config=cfg, device="cuda")


def test_entry_points_default_to_the_card():
    """With no ``device``, the entry points render on the GPU: without one
    they raise rather than fall back to the CPU."""
    cfg = RenderConfig(width=32, height=32, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2)
    scene = audio_app.build_scene(device="cpu")
    calls = (lambda: audio_app.build_scene(),
             lambda: audio_app.render_audio_app(config=cfg),
             lambda: pipeline.prepare_frame(scene, cam, Lighting.default(),
                                            cfg),
             lambda: pipeline.render_frame(scene, cam, Lighting.default(),
                                           cfg))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            t = out[0] if isinstance(out, tuple) else getattr(
                out, "uniforms", None)
            if t is None:
                t = out.instances[0].model_matrix
            assert t.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def _psnr_ok(fb_p, fb_j, st_p, st_j, bar=40.0):
    psnr = _psnr(fb_p.numpy(), np.asarray(fb_j))
    assert psnr >= bar, psnr
    assert abs(float(st_p["covered_fraction"]) -
               float(st_j["covered_fraction"])) <= 1e-6
    assert 0.05 < float(st_p["covered_fraction"]) < 1.0
    return psnr


@pytest.mark.parametrize("case", ["reference", "textures", "split",
                                  "tiles", "directional", "per_sample"])
def test_branches_not_ported_raise(case):
    """Every branch of ``render_frame`` on a 32x32 flagship frame. The
    branches the split path covers (a textured scene, ``fused_shade=False``,
    a directional light) and those of the per-sample G-buffer (16x128
    main-pass tiles, supersampled shading: kernel K3s' twin) render the JAX
    reference's frame of the same configuration (>= 40 dB, covered fraction
    within 1e-6), and so does the port's own brute-force oracle
    (``backend="reference"``): no branch raises any more."""
    w = h = 32
    cfg = RenderConfig(width=w, height=h, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2)
    jcam = JCamera(radius=5.0, theta=2.5, phi=1.2)
    jcfg = JConfig(width=w, height=h, shadow_map_size=64)
    target = (0.0, 0.0, -1.0)
    scene = audio_app.build_scene(device="cpu")
    jscene = j_app.build_scene()
    lighting, jlighting = Lighting(light=PointLight()), JLighting.default()
    backend = "reference" if case == "reference" else "kernels"
    if case == "tiles":
        cfg, jcfg = cfg.replace(tile_h=16), jcfg.replace(tile_h=16)
    elif case == "per_sample":
        cfg = cfg.replace(shading_per_pixel=False)
        jcfg = jcfg.replace(shading_per_pixel=False)
    elif case == "textures":
        scene = audio_app.build_scene(textures=(audio_app.grass_texture(),),
                                      cube_texture_id=0, device="cpu")
        jscene = j_app.build_scene(textures=(j_app.grass_texture(),),
                                   cube_texture_id=0)
    elif case == "split":
        cfg = cfg.replace(fused_shade=False)
    else:
        lighting = Lighting(light=DirectionalLight())
        jlighting = JLighting(light=JDirectional())
    before = dict(raster_cuda.LAUNCHES)
    fb_p, st_p = pipeline.render_frame(scene, cam, lighting, cfg,
                                       shadow_target=target, backend=backend,
                                       device="cpu")
    assert raster_cuda.LAUNCHES == before
    assert fb_p.shape == (h, w, 4)
    fb_j, st_j = mr.render(jscene, jcam, jlighting, jcfg,
                           shadow_target=target, backend="reference")
    _psnr_ok(fb_p, fb_j, st_p, st_j)


@pytest.mark.parametrize("shadow_per_pixel", [True, False])
def test_supersampled_frame_matches_jax_reference(shadow_per_pixel):
    """``shading_per_pixel=False`` at 96x72 MSAA4 (K1, K3s, K7 twins, every
    sample shaded, box resolve) against the JAX reference of the same
    configuration, with the shadow test per pixel and per sample."""
    w, h = 96, 72
    kw = dict(width=w, height=h, msaa=4, shadow_map_size=128,
              shading_per_pixel=False, shadow_per_pixel=shadow_per_pixel)
    jcam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
    fb_j, st_j = j_app.render_audio_app(displacement=0.02, camera=jcam,
                                        backend="reference",
                                        config=JConfig(**kw))
    fb_p, st_p = audio_app.render_audio_app(
        displacement=0.02, camera=convert.camera_from_jax(jcam),
        config=RenderConfig(**kw), device="cpu")
    assert fb_p.shape == (h, w, 4) and torch.isfinite(fb_p).all()
    _psnr_ok(fb_p, fb_j, st_p, st_j)
    assert set(st_p) == set(st_j)


def test_per_pixel_noop_at_msaa1():
    """With one sample per pixel, per-pixel and supersampled shading are
    the same frame, bit for bit (tests/test_per_pixel_shading.py:43), and
    the fused kernel's within 1e-6 of it."""
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=96 / 72)
    base = RenderConfig(width=96, height=72, msaa=1, shadow_map_size=128)
    fb_ss, st_ss = audio_app.render_audio_app(
        camera=cam, config=base.replace(shading_per_pixel=False),
        device="cpu")
    fb_px, st_px = audio_app.render_audio_app(
        camera=cam, config=base.replace(tile_h=16), device="cpu")
    assert torch.equal(fb_px, fb_ss)
    fb_f, st_f = audio_app.render_audio_app(camera=cam, config=base,
                                            device="cpu")
    assert float((fb_f - fb_ss).abs().max()) <= 1e-6
    assert float(st_f["covered_fraction"]) == float(st_ss["covered_fraction"])


def test_config4_matches_jax_reference():
    """BASELINE config 4 (normal-mapped cube, directional shadow-mapped
    sun) at 128x96 MSAA4 with a 128^2 shadow map."""
    w, h = 128, 96
    scene, cam, lighting, cfg = configs.config4_shadow_normal_map(
        w, h, device="cpu")
    cfg = cfg.replace(shadow_map_size=128)
    fb_p, st_p = pipeline.render_frame(scene, cam, lighting, cfg,
                                       device="cpu")
    js, jcam, jl, jcfg = j_configs.config4_shadow_normal_map(w, h)
    fb_j, st_j = mr.render(js, jcam, jl, jcfg.replace(shadow_map_size=128),
                           backend="reference")
    assert fb_p.shape == (h, w, 4) and torch.isfinite(fb_p).all()
    _psnr_ok(fb_p, fb_j, st_p, st_j)
    for k in ("num_triangles", "culled_triangles", "big_dropped",
              "shadow_big_dropped", "xyclip_triangles"):
        assert int(st_p[k]) == int(st_j[k]), k
    # The JAX scene and lighting carried across by ``convert`` render the
    # same frame, bit for bit.
    fb_c, st_c = pipeline.render_frame(
        convert.scene_from_jax(js), convert.camera_from_jax(jcam),
        convert.lighting_from_jax(jl), cfg, device="cpu")
    assert torch.equal(fb_c, fb_p)
    assert all(torch.equal(st_c[k], st_p[k]) for k in st_p)


def test_grass_cube_matches_golden_and_jax_reference():
    w, h = 160, 120
    cfg = RenderConfig(width=w, height=h, msaa=4, shadow_map_size=128)
    fb_p, st_p = audio_app.render_audio_app(
        config=cfg, camera=OrbitCamera(radius=5.0, theta=2.5, phi=1.2,
                                       aspect=w / h),
        textures=(audio_app.grass_texture(),), cube_texture_id=0,
        device="cpu")
    golden = png.read_png(GOLDENS / "grass_cube_160x120.png")
    assert _psnr(fb_p.numpy()[..., :3],
                 golden[..., :3].astype(np.float32) / 255.0) >= 40.0
    fb_j, st_j = j_app.render_audio_app(
        config=JConfig(width=w, height=h, msaa=4, shadow_map_size=128),
        camera=JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h),
        backend="reference", textures=(j_app.grass_texture(),),
        cube_texture_id=0)
    _psnr_ok(fb_p, fb_j, st_p, st_j)


def test_flagship_split_path_matches_fused():
    """``fused_shade=False`` sends the flagship frame through K3 + deferred
    shading; it must give the fused kernel's frame: the same shading
    expressions, so rgba within 1e-6 and the same covered fraction."""
    cfg = RenderConfig(width=96, height=72, msaa=4, shadow_map_size=128)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=96 / 72)
    fb_f, st_f = audio_app.render_audio_app(
        displacement=0.02, camera=cam, config=cfg, device="cpu")
    fb_s, st_s = audio_app.render_audio_app(
        displacement=0.02, camera=cam, config=cfg.replace(fused_shade=False),
        device="cpu")
    assert torch.equal(st_f["covered_fraction"], st_s["covered_fraction"])
    assert float((fb_f - fb_s).abs().max()) <= 1e-6
