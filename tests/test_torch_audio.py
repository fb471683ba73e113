"""Port parity, the audio pipeline: the port's analyzer, interpreter and
audio->visual mapping against the JAX package's on the same seeded signal
(numpy, seed 0: stepped tones 110/220/440/880 Hz, a noise burst, silence,
a quiet tone; 48 kHz).

Tolerances, with their reasons. The per-chunk features come from a library
FFT on both sides (XLA's and torch's), sums over 513 bins in
another order, and ``cos``/``abs``/``sqrt``/``log2`` routines one ulp
apart: features within 1e-5 relative to their magnitude (floor 1e-6 for
values near zero), the best autocorrelation lag (hence the pitch) EQUAL.
The carries (rolling sum, band EMAs, brightness envelope) run in float32
in chunk order on both sides and inherit only that input noise. Integer
results (bin edges, ring-buffer index and count) are equal. Two
leaves are ill-conditioned and held to ABSOLUTE bars when the two sides
run their own FFTs: the melancholy (1e-4; measured 2.6e-5), whose
minor/major-third ratio sums bins that, for a pure tone mis-detected at
1500 Hz, hold only window leakage at 1e-5 of the peak, where two float32
FFTs differ by 1e-2 relative; and the light color (2e-5; measured 5e-6),
whose hue takes 0.08 of the melancholy and one ulp of ``log2`` at hue ~4.8
and multiplies both by 6 in the sector fraction ``6*hue - floor(6*hue)``. On the noise
burst, where the spectrum is dense, the melancholy's minor/major-third
windows sit on different bins only if the pitch differed, which it must
not.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.audio import analyzer as j_an
from metalrenderer_tpu.audio import interpreter as j_in
from metalrenderer_tpu.audio import mapping as j_map
from metalrenderer_tpu.engine import renderer as j_renderer
from metalrenderer_tpu.io import wav as j_wav

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.audio import analyzer, interpreter, mapping
from metalrenderer_tpu_torch.engine import renderer
from metalrenderer_tpu_torch.io import wav

torch.set_num_threads(2)
SR = 48000.0
N = analyzer.FFT_SIZE


def seeded_signal(chunks_per_step=3, seed=0):
    """Stepped tones, a noise burst, silence and a quiet tone."""
    rng = np.random.default_rng(seed)
    n = chunks_per_step * N
    t = np.arange(n) / SR
    parts = [0.4 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
             for f in (110.0, 220.0, 440.0, 880.0)]
    parts.append(0.3 * rng.standard_normal(n))
    parts.append(np.zeros(n))
    parts.append(0.002 * np.sin(2 * np.pi * 330.0 * t))
    return np.concatenate(parts).astype(np.float32)


# Absolute bars where two FFT libraries meet (see the module docstring).
COLOR_ABS = 2e-5
MELANCHOLY_ABS = 1e-4


def track_floor(name):
    """The absolute floor of ``close`` for a track leaf."""
    return {"light_color": COLOR_ABS, "melancholy": MELANCHOLY_ABS}.get(
        name, 1e-6)


def close(a, b, rel=1e-5, floor=1e-6, msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, msg
    err = np.abs(a - b) / np.maximum(np.abs(b), floor / rel)
    assert float(err.max(initial=0.0)) <= rel, (msg, float(err.max()))


def _fields(x):
    return [f.name for f in dataclasses.fields(x)]


def test_analyze_stream_matches_jax():
    sig = seeded_signal()
    st_j, res_j = j_an.analyze_stream(jnp.asarray(sig), SR)
    st_p, res_p = analyzer.analyze_stream(sig, SR, device="cpu")
    assert res_p.spectrum.shape == (21, 513)
    lag_j = np.rint(SR / np.asarray(res_j.pitch_hz))
    lag_p = np.rint(SR / res_p.pitch_hz.numpy())
    np.testing.assert_array_equal(lag_p, lag_j)        # best lag equal
    for name in _fields(res_p):
        scale = 1e-3 if name == "spectrum" else 1e-6   # leakage bins ~1e-9
        close(getattr(res_p, name).numpy(), getattr(res_j, name),
              floor=scale, msg=name)
    assert int(st_p.rolling_count) == int(st_j.rolling_count) == 21
    assert int(st_p.rolling_idx) == int(st_j.rolling_idx)
    for name in ("rolling", "rolling_sum", "smoothed_bass", "smoothed_mid",
                 "smoothed_treble"):
        close(getattr(st_p, name).numpy(), getattr(st_j, name), msg=name)
    # The signal exercises every gate of the mapping.
    rms = res_p.rms.numpy()
    assert rms[0] > 0.2 and rms[16] == 0.0 and 0 < rms[19] < 0.003


def test_low_tone_pitch_quirk_is_reproduced():
    """The 110 Hz steps are mis-detected at the minimum lag (sr/1500 = 32
    samples, 1500 Hz) with confidence ~0.89, as the reference and the JAX
    package do; 220, 440 and 880 Hz are found."""
    _, res = analyzer.analyze_stream(seeded_signal(), SR, device="cpu")
    pitch, conf = res.pitch_hz.numpy(), res.pitch_confidence.numpy()
    assert (pitch[:3] == 1500.0).all() and (conf[:3] > 0.85).all()
    for step, f in ((1, 220.0), (2, 440.0), (3, 880.0)):
        assert (np.abs(pitch[3 * step:3 * step + 3] - f) / f < 0.1).all()
    # Silence: no correlation anywhere, the first lag wins with confidence 0.
    assert pitch[16] == 1500.0 and conf[16] == 0.0


def test_rolling_window_wraps_at_120():
    """125 chunks of rising loudness: the window holds the last 120."""
    amps = np.linspace(0.01, 0.5, 125, dtype=np.float32)
    sig = (amps[:, None] * np.ones((1, N), np.float32)).reshape(-1)
    st_j, res_j = j_an.analyze_stream(jnp.asarray(sig), SR)
    st_p, res_p = analyzer.analyze_stream(sig, SR, device="cpu")
    assert int(st_p.rolling_count) == 120
    assert int(st_p.rolling_idx) == int(st_j.rolling_idx) == 5
    close(res_p.rolling_avg.numpy(), res_j.rolling_avg)
    close(st_p.rolling.numpy(), st_j.rolling)
    close(st_p.rolling_sum.numpy(), st_j.rolling_sum)


def test_process_chunk_mono_and_stereo():
    sig = seeded_signal()
    stereo = np.stack([sig[3 * N:4 * N], sig[12 * N:13 * N]])
    for samples in (sig[6 * N:7 * N], stereo):
        st_j, r_j = j_an.process_chunk(j_an.AnalyzerState.init(),
                                       jnp.asarray(samples), SR)
        st_p, r_p = analyzer.process_chunk(analyzer.AnalyzerState.init(),
                                           samples, SR, device="cpu")
        assert r_p.rms.dim() == 0 and r_p.spectrum.shape == (513,)
        for name in _fields(r_p):
            close(getattr(r_p, name).numpy(), getattr(r_j, name),
                  floor=1e-3 if name == "spectrum" else 1e-6, msg=name)
        close(st_p.rolling_sum.numpy(), st_j.rolling_sum)


def test_band_edges_truncate_like_jax():
    rng = np.random.default_rng(3)
    spec = rng.uniform(0, 1, 513).astype(np.float32)
    for sr in (48000.0, 44100.0, 22050.0, 8000.0, 96000.0):
        b_j = j_an.band_energies(jnp.asarray(spec), jnp.float32(sr))
        b_p = analyzer.band_energies(torch.from_numpy(spec), sr)
        close([float(x) for x in b_p], [float(x) for x in b_j], msg=str(sr))


def test_state_carries_across_calls_and_converts():
    """Two calls with the carried state equal one call over the whole
    signal, bit for bit; and a stream begun in the JAX package continues
    in the port from the converted states as the JAX package continues."""
    sig = seeded_signal()
    half = 10 * N
    one = renderer.audio_visual_track(sig, SR, device="cpu")
    a1, v1, p1, c1 = renderer.audio_visual_track(sig[:half], SR, device="cpu")
    a2, v2, p2, c2 = renderer.audio_visual_track(sig[half:], SR, a1, v1,
                                                 device="cpu")
    for name in _fields(p1):
        both = torch.cat([getattr(p1, name), getattr(p2, name)])
        assert torch.equal(both, getattr(one[2], name)), name
    for name in _fields(a2):
        assert torch.equal(getattr(a2, name), getattr(one[0], name)), name
    assert torch.equal(v2.brightness_envelope, one[1].brightness_envelope)

    ja, jv, _, _ = j_renderer.audio_visual_track(jnp.asarray(sig[:half]), SR)
    ja2, jv2, jp2, jc2 = j_renderer.audio_visual_track(
        jnp.asarray(sig[half:]), SR, ja, jv)
    a3, v3, p3, c3 = renderer.audio_visual_track(
        sig[half:], SR, convert.analyzer_state_from_jax(ja),
        convert.visual_state_from_jax(jv), device="cpu")
    for name in _fields(p3):
        close(getattr(p3, name).numpy(), getattr(jp2, name), msg=name,
              floor=track_floor(name))
    for name in _fields(c3):
        close(getattr(c3, name).numpy(), getattr(jc2, name), msg=name,
              floor=track_floor(name))
    close(v3.brightness_envelope.numpy(), jv2.brightness_envelope)
    assert int(a3.rolling_count) == int(ja2.rolling_count)
    back = convert.visual_params_from_jax(jp2)
    assert back.light_color.shape == (11, 3)
    np.testing.assert_array_equal(back.displacement.numpy(),
                                  np.asarray(jp2.displacement))


def test_interpret_and_mapping_match_jax_on_the_same_features():
    """The JAX analyzer's results carried across: only the interpreter and
    the mapping differ."""
    sig = seeded_signal()
    _, res_j = j_an.analyze_stream(jnp.asarray(sig), SR)
    res_p = analyzer.AnalysisResult(**{
        n: convert.tensor(getattr(res_j, n)) for n in _fields(res_j)})
    import jax
    ctx_j = jax.vmap(lambda r: j_in.interpret(r, SR))(res_j)
    ctx_p = interpreter.interpret(res_p, SR)
    for name in _fields(ctx_p):
        close(getattr(ctx_p, name).numpy(), getattr(ctx_j, name), msg=name)
    assert bool((ctx_p.pitch_confidence >= 0.25).any())
    assert bool((ctx_p.pitch_confidence < 0.25).any())

    vs_j, vs_p = j_map.VisualState.init(), mapping.VisualState.init()
    for i in range(res_p.rms.shape[0]):      # frame by frame, as the scan
        ci = j_in.MusicalContext(**{n: getattr(ctx_j, n)[i]
                                    for n in _fields(ctx_p)})
        vs_j, vp_j = j_map.map_audio_to_visual(vs_j, ci, res_j.rms[i],
                                               res_j.rolling_avg[i])
        pi = interpreter.MusicalContext(**{n: getattr(ctx_p, n)[i]
                                           for n in _fields(ctx_p)})
        vs_p, vp_p = mapping.map_audio_to_visual(vs_p, pi, res_p.rms[i],
                                                 res_p.rolling_avg[i])
        assert vp_p.light_color.shape == (3,)
        for name in _fields(vp_p):
            close(getattr(vp_p, name).numpy(), getattr(vp_j, name),
                  msg=f"{name}[{i}]", floor=track_floor(name))
    # The whole track at once is the frame-by-frame result, bit for bit.
    _, track = mapping.map_audio_to_visual(mapping.VisualState.init(), ctx_p,
                                           res_p.rms, res_p.rolling_avg)
    assert torch.equal(track.light_intensity[-1], vp_p.light_intensity)
    assert torch.equal(track.light_color[-1], vp_p.light_color)


def test_brightness_envelope_attack_decay():
    """Instant attack, decay by 0.96 a frame, gray light in silence, and
    displacement = rollingAvg * 25 (tests/test_audio.py's case)."""
    def ctx(**kw):
        return interpreter.MusicalContext(**{
            k: torch.tensor(v, dtype=torch.float32) for k, v in kw.items()})
    loud = ctx(energy=1.0, brightness=1.0, melancholy=0.5,
               dominant_pitch=220.0, pitch_confidence=0.9)
    quiet = ctx(energy=0.0, brightness=0.0, melancholy=0.5,
                dominant_pitch=0.0, pitch_confidence=0.0)
    st, vp = mapping.map_audio_to_visual(mapping.VisualState.init(), loud,
                                         0.1, 0.01)
    assert float(vp.light_intensity) == 1.0
    st, vp2 = mapping.map_audio_to_visual(st, quiet, 0.0, 0.0)
    np.testing.assert_allclose(float(vp2.light_intensity), 0.96, rtol=1e-6)
    np.testing.assert_allclose(vp2.light_color.numpy(),
                               np.full(3, 0.96 / 3.0), rtol=1e-6)
    st, vp3 = mapping.map_audio_to_visual(st, quiet, 0.0, 0.02)
    np.testing.assert_allclose(float(vp3.displacement), 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(st.brightness_envelope), 0.96 * 0.96,
                               rtol=1e-6)


@pytest.mark.parametrize("hue", [0.0, 1 / 3, 2 / 3, 0.999, 1.0, -0.25, 1.7])
def test_hue_to_rgb_matches_jax(hue):
    out = mapping.hue_to_rgb(torch.tensor(hue, dtype=torch.float32))
    ref = j_map.hue_to_rgb(jnp.float32(hue))
    close(out.numpy(), ref)


def test_hue_wraps_like_jnp_mod():
    """A pitch below 55 Hz gives negative semitones: the hue wraps upward
    (``jnp.mod`` takes the divisor's sign)."""
    for pitch in (50.0, 54.9, 55.0, 109.9, 1999.0):
        ctx = dict(energy=0.5, brightness=0.5, melancholy=0.3,
                   dominant_pitch=pitch, pitch_confidence=0.9)
        _, vp_j = j_map.map_audio_to_visual(
            j_map.VisualState.init(),
            j_in.MusicalContext(**{k: jnp.float32(v)
                                   for k, v in ctx.items()}), 0.1, 0.01)
        _, vp_p = mapping.map_audio_to_visual(
            mapping.VisualState.init(),
            interpreter.MusicalContext(**{
                k: torch.tensor(v, dtype=torch.float32)
                for k, v in ctx.items()}), 0.1, 0.01)
        close(vp_p.light_color.numpy(), vp_j.light_color, msg=str(pitch),
              floor=COLOR_ABS)


def test_wav_roundtrip_matches_jax(tmp_path):
    sig = seeded_signal(2)[:4800]          # the tone steps: no clipping
    wav.write_wav(tmp_path / "p.wav", sig, 48000)
    j_wav.write_wav(tmp_path / "j.wav", sig, 48000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back, rate = wav.read_wav(tmp_path / "j.wav")
    back_j, rate_j = j_wav.read_wav(tmp_path / "p.wav")
    assert rate == rate_j == 48000 and back.shape == (1, 4800)
    np.testing.assert_array_equal(back, back_j)
    np.testing.assert_allclose(back[0], sig, atol=1e-4)
