"""Port parity, the audio-reactive sequence: WAV-like samples in, frames
out, through ``metalrenderer_tpu_torch.engine.renderer`` on the CPU (the
kernels' plain twins) against the JAX package's ``engine.renderer``.

Tolerances, with their reasons:
  * the track (``VisualParams`` and ``MusicalContext`` of every frame):
    1e-5 relative, as tests/test_torch_audio.py states for the features
    they are computed from, with its absolute bars for the melancholy
    (1e-4) and the light color (2e-5), which are ill-conditioned where two
    FFT libraries meet;
  * frames against the JAX ``backend="reference"`` sequence at 64x64
    MSAA1: >= 40 dB PSNR per frame (the BASELINE.md bar; measured ~70 dB:
    the light's color differs by the track's 1e-5 and edge pixels by the
    prep's rounding, ROADMAP C9);
  * stream == offline: BIT-EQUAL on the CPU, frames and telemetry, across
    a padded last chunk and on both branches — torch's CPU FFT, sums and
    prefix sums work row by row, so a chunk's features do not depend on
    how many chunks share its batch, and the carries run in order;
  * every frame of a sequence BIT-EQUAL to ``render_frame`` of that
    frame's parameters, on both branches.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import renderer as j_renderer
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera

from test_torch_audio import SR, close, seeded_signal, track_floor

from metalrenderer_tpu_torch.audio import analyzer, mapping
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app, renderer
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import raster_cuda
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight

torch.set_num_threads(2)
CFG = RenderConfig(width=64, height=64, msaa=1, shadow_map_size=64)
CAM = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=1.0)
TELEMETRY = {"light_color", "light_intensity", "displacement", "energy",
             "brightness", "melancholy", "pitch_hz", "pitch_confidence"}


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _signal():
    """Five chunks: a loud 220 Hz tone, a noise burst, silence."""
    sig = seeded_signal(1)
    return np.concatenate([sig[1024:3072], sig[4096:6144], sig[5120:6144]])


def _spy(monkeypatch):
    called = []
    for name in ("render_frame_batch_fused", "render_frame"):
        fn = getattr(renderer, name)

        def spy(*a, _fn=fn, _name=name, **k):
            called.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(renderer, name, spy)
    return called


def test_audio_visual_track_matches_jax():
    sig = seeded_signal()
    _, jv, jp, jc = j_renderer.audio_visual_track(jnp.asarray(sig), SR)
    a, v, p, c = renderer.audio_visual_track(sig, SR, device="cpu")
    assert p.light_color.shape == (21, 3) and p.displacement.shape == (21,)
    for name in ("light_color", "light_intensity", "displacement"):
        close(getattr(p, name).numpy(), getattr(jp, name), msg=name,
              floor=track_floor(name))
    for name in ("energy", "brightness", "melancholy", "dominant_pitch",
                 "pitch_confidence"):
        close(getattr(c, name).numpy(), getattr(jc, name), msg=name,
              floor=track_floor(name))
    close(v.brightness_envelope.numpy(), jv.brightness_envelope)
    # Reactivity: the first chunk sees an empty window; silence is gray.
    inten = p.light_intensity.numpy()
    assert float(p.displacement[0]) == 0.0 and float(p.displacement[2]) > 0
    assert inten[0] < inten[1] == 1.0
    gray = p.light_color[16].numpy() / inten[16]
    np.testing.assert_allclose(gray, np.full(3, 1 / 3), rtol=1e-6)
    assert a.rolling.device.type == "cpu"


def test_sequence_matches_jax_reference(monkeypatch):
    """The fused-batch branch (K4 + K6 twins) against the JAX reference
    backend's frames of the same signal."""
    sig = _signal()
    called = _spy(monkeypatch)
    before = dict(raster_cuda.LAUNCHES)
    frames, telem = renderer.render_audio_reactive_sequence(
        sig, SR, camera=CAM, config=CFG, device="cpu")
    assert called == ["render_frame_batch_fused"]
    assert raster_cuda.LAUNCHES == before           # CPU: the twins ran
    frames_j, telem_j = j_renderer.render_audio_reactive_sequence(
        jnp.asarray(sig), SR,
        camera=JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=1.0),
        config=JConfig(width=64, height=64, msaa=1, shadow_map_size=64),
        backend="reference")
    frames_j = np.asarray(frames_j)
    assert frames.shape == frames_j.shape == (5, 64, 64, 4)
    assert bool(torch.isfinite(frames).all())
    for f in range(5):
        assert _psnr(frames[f].numpy(), frames_j[f]) >= 40.0, f
    assert set(telem) == set(telem_j) == TELEMETRY
    for k in TELEMETRY:
        close(telem[k].numpy(), telem_j[k], msg=k, floor=track_floor(k))
    # The light follows the audio: loud, noisy and silent frames differ.
    assert not torch.allclose(frames[1], frames[4])
    # Each frame is render_frame of its own parameters, bit for bit.
    for f in (0, 3):
        color = telem["light_color"][f]
        fb, _ = pipeline.render_frame(
            audio_app.build_scene(light_color=color, device="cpu"), CAM,
            Lighting(light=PointLight(color=color,
                                      intensity=telem["light_intensity"][f])),
            CFG, displacement=float(telem["displacement"][f]),
            shadow_target=(0.0, 0.0, -1.0), device="cpu")
        assert torch.equal(fb, frames[f]), f
    # max_frames trims the sequence and its telemetry.
    two, telem2 = renderer.render_audio_reactive_sequence(
        sig, SR, camera=CAM, config=CFG, max_frames=2, device="cpu")
    assert torch.equal(two, frames[:2])
    assert telem2["pitch_hz"].shape == (2,)


@pytest.mark.parametrize("branch", ["fused_batch", "per_frame"])
def test_stream_equals_offline_sequence(branch, monkeypatch):
    """Chunked rendering with carried analyzer and visual state reproduces
    the offline sequence exactly, across a padded last chunk."""
    sig = _signal()
    cfg = CFG if branch == "fused_batch" else CFG.replace(fused_shade=False)
    offline, telem = renderer.render_audio_reactive_sequence(
        sig, SR, camera=CAM, config=cfg, device="cpu")
    called = _spy(monkeypatch)
    chunks = list(renderer.stream_audio_reactive(
        sig, SR, chunk_frames=2, camera=CAM, config=cfg, device="cpu"))
    assert [f.shape[0] for f, _ in chunks] == [2, 2, 1]
    want = (["render_frame_batch_fused"] * 3 if branch == "fused_batch"
            else ["render_frame"] * 5)          # the padding is not rendered
    assert called == want
    assert torch.equal(torch.cat([f for f, _ in chunks]), offline)
    for k in TELEMETRY:
        assert torch.equal(torch.cat([t[k] for _, t in chunks]), telem[k]), k
    # No audio, no chunk.
    assert list(renderer.stream_audio_reactive(sig[:1000], SR, camera=CAM,
                                               config=cfg,
                                               device="cpu")) == []


@pytest.mark.parametrize("case", ["supersampled", "tiles"])
def test_per_sample_sequence_takes_the_per_frame_branch(case, monkeypatch):
    """Supersampled shading (or other main-pass tiles) leaves the fused
    batch: one ``render_frame`` (K1 + K3s + K7 twins) per frame, each frame
    bit-equal to ``render_frame`` of its parameters."""
    cfg = RenderConfig(width=48, height=40, msaa=4, shadow_map_size=64)
    cfg = (cfg.replace(shading_per_pixel=False) if case == "supersampled"
           else cfg.replace(tile_h=16))
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=48 / 40)
    sig = _signal()[:3 * 1024]
    called = _spy(monkeypatch)
    frames, telem = renderer.render_audio_reactive_sequence(
        sig, SR, camera=cam, config=cfg, device="cpu")
    assert called == ["render_frame"] * 3
    assert frames.shape == (3, 40, 48, 4)
    color = telem["light_color"][2]
    fb, _ = pipeline.render_frame(
        audio_app.build_scene(light_color=color, device="cpu"), cam,
        Lighting(light=PointLight(color=color)), cfg,
        displacement=float(telem["displacement"][2]),
        shadow_target=(0.0, 0.0, -1.0), device="cpu")
    assert torch.equal(fb, frames[2])
    # The default configuration renders the same signal through the fused
    # batch; supersampling moves only edge and highlight pixels.
    fused, _ = renderer.render_audio_reactive_sequence(
        sig, SR, camera=cam, config=cfg.replace(shading_per_pixel=True,
                                                tile_h=8), device="cpu")
    assert called[3:] == ["render_frame_batch_fused"]
    assert _psnr(frames.numpy(), fused.numpy()) >= 30.0
    if case == "tiles":     # per-pixel shading either way: the same frames
        assert float((frames - fused).abs().max()) <= 1e-6


def test_sequence_entry_points_default_to_the_card():
    """With no ``device`` the audio entry points run on the GPU: without
    one they raise rather than fall back to the CPU."""
    sig = _signal()
    calls = (
        lambda: analyzer.analyze_stream(sig, SR)[1].rms,
        lambda: analyzer.process_chunk(analyzer.AnalyzerState.init(),
                                       sig[:1024], SR)[1].rms,
        lambda: renderer.audio_visual_track(sig, SR)[2].displacement,
        lambda: renderer.render_audio_reactive_sequence(
            sig, SR, camera=CAM, config=CFG)[0],
        lambda: next(renderer.stream_audio_reactive(
            sig, SR, camera=CAM, config=CFG))[0])
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    with pytest.raises(ValueError, match="chunk"):
        renderer.render_audio_reactive_sequence(sig[:100], SR, camera=CAM,
                                                config=CFG, device="cpu")
    assert isinstance(mapping.VisualState.init().brightness_envelope,
                      torch.Tensor)
