"""Port parity, the utilities: ``metalrenderer_tpu_torch.utils`` (stats,
dashboard, checkpoint, profiling) on the CPU against the JAX package's.

Tolerances, with their reasons:
  * the dashboard of tests/test_dashboard.py's fixture BIT-EQUAL to the
    committed golden ``tests/goldens/dashboard_telemetry.png`` (RGB; read,
    never written): the drawing is the same numpy code;
  * a dashboard from the port's analyzer against the JAX one from JAX's
    analyzer on a seeded signal: at most 0.5 % of the pixels differ (the
    analyzers agree within 1e-5 relative, tests/test_torch_audio.py, and
    the panel rounds bar heights, plot columns and two-decimal readouts,
    where a 1e-5 difference can flip one pixel row or one digit; measured
    0 pixels on this signal);
  * ``spectrum_rows``, ``display_bands``, ``to_json``: equal to JAX's;
  * checkpoints: leaves restored BIT-EQUAL; a stream resumed from a
    checkpoint equals the unbroken run bit for bit (the port's analyzer
    carries its state on the host in order, so a split stream is the same
    computation); the JAX package's ``rtol=1e-5`` bars are kept where its
    own test states them.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.audio import analyzer as j_analyzer
from metalrenderer_tpu.audio import interpreter as j_interpreter
from metalrenderer_tpu.audio import mapping as j_mapping
from metalrenderer_tpu.engine import audio_app as j_audio_app
from metalrenderer_tpu.utils import checkpoint as j_checkpoint
from metalrenderer_tpu.utils import dashboard as j_dashboard
from metalrenderer_tpu.utils import stats as j_stats

from test_torch_audio import SR, seeded_signal

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.audio import analyzer, interpreter, mapping
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app, renderer
from metalrenderer_tpu_torch.io import png
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.utils import (checkpoint, dashboard, profiling,
                                           stats)

torch.set_num_threads(2)
GOLDEN = pathlib.Path(__file__).parent / "goldens" / "dashboard_telemetry.png"


class _Ctx:
    energy = 0.52
    brightness = 0.41
    melancholy = 0.23


def _fixture_image(mod):
    rng = np.random.default_rng(5)
    k = np.arange(513)
    spec = (np.exp(-0.5 * ((k - 10) / 3.0) ** 2) * 0.8
            + np.exp(-0.5 * ((k - 40) / 6.0) ** 2) * 0.3
            + 0.01 * rng.random(513)).astype(np.float32)
    return mod.render_dashboard(
        rms=0.0123, rolling_avg=0.0045, spectrum=spec, bass=0.11,
        mid=0.35, treble=0.06, pitch_hz=440.0, pitch_confidence=0.82,
        context=_Ctx, sample_rate=48000.0, fps=59.9)


def test_dashboard_matches_golden():
    img = _fixture_image(dashboard)
    golden = png.read_png(GOLDEN)
    assert img.dtype == np.uint8 and img.shape == golden.shape[:2] + (4,)
    np.testing.assert_array_equal(img[..., :3], golden[..., :3])
    np.testing.assert_array_equal(img, _fixture_image(j_dashboard))


def test_result_dashboard_matches_jax():
    sig = seeded_signal()
    _, jres = j_analyzer.analyze_stream(jnp.asarray(sig), SR)
    import jax
    jctx = jax.vmap(lambda r: j_interpreter.interpret(r, SR))(jres)
    _, res = analyzer.analyze_stream(sig, SR, device="cpu")
    ctx = interpreter.interpret(res, SR)
    n = res.rms.shape[0]
    assert n == jres.rms.shape[0]
    for i in (0, n // 2, n - 1):
        a = j_dashboard.render_result_dashboard(jres, i, context=jctx,
                                                sample_rate=SR)
        b = dashboard.render_result_dashboard(res, i, context=ctx,
                                              sample_rate=SR, fps=None)
        assert a.shape == b.shape and b.dtype == np.uint8
        assert np.mean(np.any(a != b, axis=-1)) <= 0.005, i
    # The spectrum line lights up the plot.
    accent = np.asarray(dashboard.ACCENT, np.uint8)
    assert (b[..., :3] == accent).all(axis=-1).sum() > 50


def test_spectrum_rows_and_display_bands_match_jax():
    spec = np.random.default_rng(2).random((3, 513)).astype(np.float32)
    for s in (spec, torch.from_numpy(spec)):
        f, rows = stats.spectrum_rows(s, 48000.0)
        jf, jrows = j_stats.spectrum_rows(spec, 48000.0)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(rows, jrows)
    # 20-4180 Hz at 46.875 Hz/bin -> bins 1..89 (mtl_engine.mm:902-916).
    assert len(f) == 89 and f.min() >= 20.0 and f.max() <= 4180.0
    assert stats.display_bands(1.0, 1.0, 1.0) == {"bass": 5.0, "mid": 0.8,
                                                 "treble": 3.0}
    for b in ((0.11, 0.35, 0.06), (torch.tensor(0.3), 0.0, 2.0)):
        assert stats.display_bands(*b) == j_stats.display_bands(
            *(float(x) for x in b))


def test_frame_clock_and_to_json():
    clock = stats.FrameClock()
    assert clock.tick() == 0.0       # the first tick has no interval
    assert clock.tick() > 0 and clock.fps > 0
    st = {"a": torch.tensor(1.5), "b": torch.tensor([1, 2],
                                                    dtype=torch.int32)}
    rec = stats.to_json(st, frame=3)
    assert rec == j_stats.to_json({"a": jnp.float32(1.5),
                                   "b": jnp.asarray([1, 2])}, frame=3)
    assert json.loads(rec) == {"a": 1.5, "b": [1, 2], "frame": 3}


# --- checkpoints -----------------------------------------------------------

def _tone(freq, chunks, amp=0.3, sr=48000.0):
    t = np.arange(chunks * 1024) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _fields_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def test_analyzer_state_roundtrip(tmp_path):
    st, _ = analyzer.analyze_stream(_tone(220.0, 4), 48000.0, device="cpu")
    p = tmp_path / "analyzer.npz"
    checkpoint.save_pytree(p, st)
    _fields_equal(st, checkpoint.restore_like(analyzer.AnalyzerState.init(),
                                              p))


def test_resume_equals_continuous(tmp_path):
    """Splitting a stream at a checkpoint equals the unbroken run: the
    analyzer's carries, and the frames of an audio-reactive stream resumed
    from the saved analyzer and visual states."""
    sig = _tone(440.0, 6)
    st_full, res_full = analyzer.analyze_stream(sig, 48000.0, device="cpu")
    st_a, _ = analyzer.analyze_stream(sig[:3 * 1024], 48000.0, device="cpu")
    p = tmp_path / "mid.npz"
    checkpoint.save_pytree(p, st_a)
    st_rest = checkpoint.restore_like(analyzer.AnalyzerState.init(), p)
    st_b, res_b = analyzer.analyze_stream(sig[3 * 1024:], 48000.0, st_rest,
                                          device="cpu")
    _fields_equal(st_full, st_b)
    assert torch.equal(res_b.rms, res_full.rms[3:])

    cfg = RenderConfig(width=32, height=32, msaa=1, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=1.0)
    sig = seeded_signal()[:6 * 1024]
    kw = dict(chunk_frames=3, camera=cam, config=cfg, device="cpu")
    unbroken = torch.cat([f for f, _ in renderer.stream_audio_reactive(
        sig, SR, **kw)])
    a_state, v_state, _, _ = renderer.audio_visual_track(
        sig[:3 * 1024], SR, device="cpu")
    checkpoint.save_pytree(tmp_path / "states.npz", (a_state, v_state))
    a_rest, v_rest = checkpoint.restore_like(
        (analyzer.AnalyzerState.init(), mapping.VisualState.init()),
        tmp_path / "states.npz")
    resumed = torch.cat([f for f, _ in renderer.stream_audio_reactive(
        sig[3 * 1024:], SR, analyzer_state=a_rest, visual_state=v_rest,
        **kw)])
    assert torch.equal(resumed, unbroken[3:])


def test_visual_state_roundtrip(tmp_path):
    vs = mapping.VisualState(brightness_envelope=torch.tensor(0.77))
    p = tmp_path / "vs.npz"
    checkpoint.save_pytree(p, vs)
    vs2 = checkpoint.restore_like(mapping.VisualState.init(), p)
    assert float(vs2.brightness_envelope) == np.float32(0.77)


def test_leaf_count_mismatch_raises(tmp_path):
    p = tmp_path / "x.npz"
    checkpoint.save_pytree(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="1 leaves"):
        checkpoint.restore_like({"a": torch.ones(3), "b": torch.ones(2)}, p)


def test_scene_checkpoint_leaf_order_matches_jax(tmp_path):
    """A scene (textures included) written by the JAX ``save_pytree``
    restores into the port's scene, and the port's checkpoint restores into
    the JAX scene: the leaf orders agree (static fields left out)."""
    grass = audio_app.grass_texture()
    j_scene = j_audio_app.build_scene(light_color=(0.2, 0.5, 0.9),
                                      textures=(tuple(jnp.asarray(m.numpy())
                                                      for m in grass),),
                                      cube_texture_id=0)
    template = audio_app.build_scene(device="cpu", textures=(grass,),
                                     cube_texture_id=0)
    p = tmp_path / "scene.npz"
    j_checkpoint.save_pytree(p, j_scene)
    scene = checkpoint.restore_like(template, p)
    want = convert.scene_from_jax(j_scene)
    leaves, _ = checkpoint.flatten(scene)
    want_leaves, _ = checkpoint.flatten(want)
    assert len(leaves) == len(want_leaves) == 3 * 5 + len(grass)
    for a, b in zip(leaves, want_leaves):
        assert torch.equal(a, b)
    assert [i.material.kind for i in scene.instances] == \
        [i.material.kind for i in template.instances]
    assert scene.instances[0].cast_shadow and \
        scene.instances[0].material.texture_id == 0
    # And back: the port's checkpoint into the JAX template.
    q = tmp_path / "scene_port.npz"
    checkpoint.save_pytree(q, scene)
    j_back = j_checkpoint.restore_like(j_scene, q)
    np.testing.assert_array_equal(
        np.asarray(j_back.instances[1].material.color),
        np.float32([0.2, 0.5, 0.9]))


def test_jax_stream_states_restore_into_port(tmp_path):
    """The JAX analyzer's and visual state's checkpoint continues the
    stream in the port: the resumed features within the audio tests' 1e-5
    relative of the JAX run's."""
    sig = seeded_signal()
    j_st, _ = j_analyzer.analyze_stream(jnp.asarray(sig[:4 * 1024]), SR)
    p = tmp_path / "j.npz"
    j_checkpoint.save_pytree(p, (j_st, j_mapping.VisualState.init()))
    a_st, v_st = checkpoint.restore_like(
        (analyzer.AnalyzerState.init(), mapping.VisualState.init()), p)
    assert a_st.rolling_idx.dtype == torch.int32
    _, j_res = j_analyzer.analyze_stream(jnp.asarray(sig[4 * 1024:]), SR,
                                         j_st)
    _, res = analyzer.analyze_stream(sig[4 * 1024:], SR, a_st, device="cpu")
    np.testing.assert_allclose(res.rolling_avg.numpy(),
                               np.asarray(j_res.rolling_avg), rtol=1e-5)
    assert float(v_st.brightness_envelope) == float(
        mapping.VisualState.init().brightness_envelope)


def test_checkpoint_restores_onto_template_device_and_kinds(tmp_path):
    tree = {"t": torch.arange(4, dtype=torch.int32), "x": 2.5,
            "n": [None, (torch.ones(2, 2), 7)]}
    p = tmp_path / "tree.npz"
    checkpoint.save_pytree(p, tree)
    back = checkpoint.restore_like(tree, p)
    assert torch.equal(back["t"], tree["t"]) and back["x"] == 2.5
    assert back["n"][0] is None and back["n"][1][1] == 7
    assert isinstance(back["n"][1], tuple)
    assert back["t"].device == tree["t"].device
    # Dict keys sorted ("n", "t", "x"), None holding no leaf.
    assert [tuple(x.shape) for x in checkpoint.load_leaves(p)] == [
        (2, 2), (), (4,), ()]


# --- profiling -------------------------------------------------------------

def test_annotate_is_one_noop_while_no_profiler_records(tmp_path):
    a, b = profiling.annotate("mr/a"), profiling.annotate("mr/b")
    assert a is b
    with profiling.device_trace(tmp_path / "trace") as prof:
        with a:
            torch.sum(torch.ones(64, 64) ** 2)
    trace = json.loads(prof.trace_path.read_text())
    assert "mr/a" not in {e.get("name") for e in trace["traceEvents"]}


def test_annotate_records_its_span_while_a_profiler_records():
    idle = profiling.annotate("mr/idle")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        span = profiling.annotate("mr/test")
        with span:
            torch.sum(torch.ones(64, 64) ** 2)
    assert span is not idle
    assert profiling.annotate("mr/after") is idle
    assert "mr/test" in {e.name for e in prof.events()}


def test_device_trace_writes_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        with profiling.annotate("traced-op"):
            torch.sum(torch.ones(64, 64) ** 2)
    assert prof.trace_path.is_file()
    trace = json.loads(prof.trace_path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "traced-op" in names
