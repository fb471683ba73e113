"""Port parity, the whole slice: the port's flagship AudioApp frame (shadow
pass + fused main pass, run by the kernels' plain twins on the CPU) against
the JAX ``backend="reference"`` oracle and the committed goldens.

Bars: >= 60 dB PSNR against the JAX reference at 96x72 — the bar
tests/test_raster_pallas.py:88 holds the Pallas kernels to — with equal
integer stats and float stats within 1e-6; >= 40 dB against the goldens
(the BASELINE.md bar; the goldens are 8-bit PNGs).
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.lights import Lighting as JLighting

from metalrenderer_tpu_torch import Lighting, PointLight, convert
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app
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
        displacement=0.01, shadow_target=(0.0, 0.0, -1.0))
    fb_p, st_p = audio_app.render_audio_app(
        displacement=0.01, camera=convert.camera_from_jax(jcam), config=cfg)
    assert torch.equal(fb_c, fb_p)
    assert all(torch.equal(st_c[k], st_p[k]) for k in st_p)


@pytest.mark.parametrize("size", [(160, 120, 256), (320, 240, 512)])
def test_flagship_frame_matches_golden(size):
    w, h, shadow = size
    golden = png.read_png(GOLDENS / f"audio_app_{w}x{h}.png")
    fb, stats = audio_app.render_audio_app(
        camera=OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h),
        config=RenderConfig(width=w, height=h, msaa=4, shadow_map_size=shadow))
    assert int(stats["big_dropped"]) == 0
    assert _psnr(fb.numpy()[..., :3], golden.astype(np.float32) / 255.0) >= 40.0


def test_port_imports_without_jax():
    code = ("import sys, metalrenderer_tpu_torch, "
            "metalrenderer_tpu_torch.engine.audio_app, "
            "metalrenderer_tpu_torch.convert; "
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


class _DirectionalLight:
    direction = (0.0, -1.0, -0.3)
    color = (1.0, 1.0, 1.0)


@pytest.mark.parametrize("case", ["reference", "textures", "split",
                                  "tiles", "directional"])
def test_branches_not_ported_raise(case):
    cfg = RenderConfig(width=32, height=32, shadow_map_size=64)
    scene = audio_app.build_scene()
    lighting = Lighting(light=PointLight())
    kw = {}
    if case == "reference":
        kw["backend"] = "reference"
    elif case == "textures":
        scene = scene.__class__(instances=scene.instances, textures=((),))
    elif case == "split":
        cfg = cfg.replace(fused_shade=False)
    elif case == "tiles":
        cfg = cfg.replace(tile_h=16)
    else:
        lighting = Lighting(light=_DirectionalLight())
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        pipeline.render_frame(scene, OrbitCamera(), lighting, cfg, **kw)
