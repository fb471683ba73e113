"""The reference's audio track: samples in, per-frame visual parameters
out, for a whole signal at once.

Frozen copies of the port's ``audio/analyzer.py`` (RMS, the windowed
spectrum, band energies, the autocorrelation pitch, the rolling and EMA
carries in float32 in chunk order), ``audio/interpreter.py`` (the musical
context) and ``audio/mapping.py`` (pitch to hue, the brightness envelope,
the displacement), ending in ``track``. The reference app's files and lines
are cited where each constant is set.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

FFT_SIZE = 1024            # AudioAnalyzer.hpp:58
SPECTRUM_SIZE = FFT_SIZE // 2 + 1
ROLLING_WINDOW = 120       # RollingAverage default (AudioAnalyzer.hpp:22)
BAND_SMOOTH_ALPHA = 0.15   # AudioAnalyzer.hpp:61
BASS_HIGH_HZ = 155.0
MID_HIGH_HZ = 880.0
TREBLE_HIGH_HZ = 4186.0
PITCH_MIN_HZ = 50.0
PITCH_MAX_HZ = 1500.0

_F32 = np.float32


@functools.cache
def _hann_norm_window_cpu(n):
    i = torch.arange(n, dtype=torch.float32)
    scale = torch.sqrt(torch.tensor(8.0 / 3.0, dtype=torch.float32)) * 0.5
    return scale * (1.0 - torch.cos(float(_F32(2.0 * np.pi)) * i / n))


def hann_norm_window(n=FFT_SIZE, device="cpu"):
    """vDSP_HANN_NORM: periodic Hann scaled to unit RMS (factor
    sqrt(8/3) ~= 1.633). Evaluated once on the host, so every device
    windows with the same values."""
    return _hann_norm_window_cpu(n).to(device)


@dataclasses.dataclass(frozen=True)
class AnalyzerState:
    """Cross-chunk carry (the reference's mutable analyzer fields), on the
    host."""

    rolling: torch.Tensor        # f32[120] ring buffer of RMS values
    rolling_idx: torch.Tensor    # i32 next write slot
    rolling_count: torch.Tensor  # i32 filled entries
    rolling_sum: torch.Tensor    # f32 running sum
    smoothed_bass: torch.Tensor  # f32 EMA state
    smoothed_mid: torch.Tensor
    smoothed_treble: torch.Tensor

    @staticmethod
    def init():
        z = torch.zeros((), dtype=torch.float32)
        zi = torch.zeros((), dtype=torch.int32)
        return AnalyzerState(
            rolling=torch.zeros((ROLLING_WINDOW,), dtype=torch.float32),
            rolling_idx=zi, rolling_count=zi, rolling_sum=z,
            smoothed_bass=z, smoothed_mid=z, smoothed_treble=z)


@dataclasses.dataclass(frozen=True)
class AnalysisResult:
    """Per-chunk features (AudioFeatures + BandEnergies + pitch + spectrum);
    from ``analyze_stream`` every leaf has a leading chunk axis."""

    rms: torch.Tensor
    rolling_avg: torch.Tensor
    spectrum: torch.Tensor       # f32[513] magnitudes
    bass: torch.Tensor           # EMA-smoothed band energies
    mid: torch.Tensor
    treble: torch.Tensor
    pitch_hz: torch.Tensor
    pitch_confidence: torch.Tensor


def _trunc_div(a, b):
    """``(a / b).astype(int32)`` in float32, on the host."""
    return int(_F32(a) / _F32(b))


def compute_spectrum(samples, window=None):
    """Windowed magnitudes, vDSP-zrip-scaled: 4|DFT_k|/N. samples:
    f32[..., 1024]. Returns (spectrum f32[..., 513], the windowed samples)."""
    if window is None:
        window = hann_norm_window(device=samples.device)
    windowed = samples * window
    fft = torch.fft.rfft(windowed)
    return (4.0 / FFT_SIZE) * torch.abs(fft).to(torch.float32), windowed


def band_energies(spectrum, sample_rate):
    """Raw band sums over f32[..., 513] (AudioAnalyzer.mm:102-127):
    (bass, mid, treble)."""
    max_bin = SPECTRUM_SIZE - 1
    bass_end = min(max(_trunc_div(BASS_HIGH_HZ * FFT_SIZE, sample_rate), 1),
                   max_bin)
    mid_end = min(max(_trunc_div(MID_HIGH_HZ * FFT_SIZE, sample_rate),
                      bass_end), max_bin)
    treble_end = min(max(_trunc_div(TREBLE_HIGH_HZ * FFT_SIZE, sample_rate),
                         mid_end), max_bin)
    return (spectrum[..., 1:bass_end + 1].sum(dim=-1),
            spectrum[..., bass_end + 1:mid_end + 1].sum(dim=-1),
            spectrum[..., mid_end + 1:treble_end + 1].sum(dim=-1))


def pitch_mpm(windowed, sample_rate):
    """Normalized autocorrelation pitch (AudioAnalyzer.mm:129-166) of
    f32[..., 1024] windowed buffers: (pitch_hz, confidence).

    For each lag: corr = sum(x_i x_{i+lag}) / sqrt(sum_{i<N-lag} x_i^2 *
    sum_{i>=lag} x_i^2). The O(lags*N) reference loop becomes one FFT
    autocorrelation + a prefix sum."""
    n = FFT_SIZE
    x = windowed
    dev = x.device
    f = torch.fft.rfft(x, 2 * n)
    ac = torch.fft.irfft(f * torch.conj(f), 2 * n)[..., :n].to(torch.float32)

    c = torch.cumsum(x * x, dim=-1)
    total = c[..., n - 1:n]
    lags = torch.arange(n, device=dev)
    sum_x2 = c[..., torch.clamp(n - lags - 1, 0, n - 1)]       # i < N-lag
    sum_y2 = total - torch.where(
        lags > 0, c[..., torch.clamp(lags - 1, 0, n - 1)],
        torch.zeros((), dtype=torch.float32, device=dev))

    denom = torch.sqrt(sum_x2 * sum_y2)
    corr = torch.where(denom > 1e-10, ac / torch.clamp_min(denom, 1e-30),
                       torch.zeros_like(ac))

    min_lag = max(_trunc_div(sample_rate, PITCH_MAX_HZ), 1)
    max_lag = min(_trunc_div(sample_rate, PITCH_MIN_HZ), n - 1)
    in_range = (lags >= min_lag) & (lags <= max_lag)
    corr_m = torch.where(in_range, corr, torch.full_like(corr, -torch.inf))
    best_lag = torch.argmax(corr_m, dim=-1)   # first strict max, like the loop
    best_corr = torch.gather(corr_m, -1, best_lag[..., None])[..., 0]

    if not min_lag < max_lag:
        zero = torch.zeros_like(best_corr)
        return zero, zero
    # A tensor numerator: a Python number over a tensor multiplies by the
    # reciprocal, which rounds twice.
    rate = torch.tensor(float(sample_rate), dtype=torch.float32, device=dev)
    pitch = rate / best_lag.to(torch.float32)
    return pitch, torch.clamp(best_corr, 0.0, 1.0)


def _carries(state: AnalyzerState, rms, bands):
    """The sequential part, on the host in float32, in chunk order: the
    rolling RMS window (RollingAverage::push, AudioAnalyzer.hpp:37-49:
    append until full, then overwrite round-robin; the average is read
    BEFORE the push) and the band EMAs. rms: f32[n], bands: f32[n, 3]
    numpy. Returns (new state, rolling_avg f32[n], smoothed f32[n, 3])."""
    rolling = state.rolling.numpy().copy()
    idx, count = int(state.rolling_idx), int(state.rolling_count)
    total = _F32(state.rolling_sum.item())
    sm = [_F32(state.smoothed_bass.item()), _F32(state.smoothed_mid.item()),
          _F32(state.smoothed_treble.item())]
    a, keep = _F32(BAND_SMOOTH_ALPHA), _F32(1 - BAND_SMOOTH_ALPHA)
    n = rms.shape[0]
    avg = np.zeros((n,), _F32)
    smoothed = np.zeros((n, 3), _F32)
    for i in range(n):
        avg[i] = total / _F32(max(count, 1)) if count > 0 else _F32(0.0)
        value = rms[i]
        full = count >= ROLLING_WINDOW
        slot = idx if full else count
        old = rolling[slot]
        rolling[slot] = value
        total = (total + value) - (old if full else _F32(0.0))
        count = min(count + 1, ROLLING_WINDOW)
        if full:
            idx = (idx + 1) % ROLLING_WINDOW
        for k in range(3):
            sm[k] = a * bands[i, k] + keep * sm[k]
            smoothed[i, k] = sm[k]

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32)

    new = AnalyzerState(
        rolling=torch.from_numpy(rolling),
        rolling_idx=torch.tensor(idx, dtype=torch.int32),
        rolling_count=torch.tensor(count, dtype=torch.int32),
        rolling_sum=f32(total), smoothed_bass=f32(sm[0]),
        smoothed_mid=f32(sm[1]), smoothed_treble=f32(sm[2]))
    return new, avg, smoothed


def _analyze(state, rms, ch0, sample_rate, window):
    """Chunks ch0 f32[n, 1024] with their RMS f32[n], on one device."""
    dev = ch0.device
    spectrum, windowed = compute_spectrum(ch0, window)
    pitch, conf = pitch_mpm(windowed, sample_rate)
    scalars = torch.stack([rms, *band_energies(spectrum, sample_rate)],
                          dim=-1).cpu().numpy()             # the one copy out
    state, avg, smoothed = _carries(state, scalars[:, 0], scalars[:, 1:])
    back = torch.from_numpy(np.concatenate([avg[:, None], smoothed],
                                           axis=1)).to(dev)
    return state, AnalysisResult(
        rms=rms, rolling_avg=back[:, 0], spectrum=spectrum,
        bass=back[:, 1], mid=back[:, 2], treble=back[:, 3],
        pitch_hz=pitch, pitch_confidence=conf)



# --- the musical interpreter (MusicalInterpreter.mm) ------------------------

ENERGY_SCALE = 150.0            # MusicalInterpreter.mm:7
PITCH_CONFIDENCE_THRESHOLD = 0.25   # :8
PITCH_MIN = 50.0                # :9
PITCH_MAX = 2000.0              # :10
SPECTRUM_WINDOW_RADIUS = 2      # :11
BASS_BOOST = 5.0                # :23
MID_BOOST = 0.8                 # :24
TREBLE_BOOST = 1.0              # :25
EPS = 1e-6                      # :30


@dataclasses.dataclass(frozen=True)
class MusicalContext:
    energy: torch.Tensor = 0.5
    brightness: torch.Tensor = 0.5
    melancholy: torch.Tensor = 0.5
    dominant_pitch: torch.Tensor = 0.0
    pitch_confidence: torch.Tensor = 0.0


def _sum_around_bin(spectrum, center_bin, radius=SPECTRUM_WINDOW_RADIUS):
    """sumAroundBin (MusicalInterpreter.mm:53-61): clamp window to
    [1, size-1] and sum. spectrum: f32[..., 513], center_bin: i32[...]."""
    k = torch.arange(SPECTRUM_SIZE, device=spectrum.device)
    lo = torch.clamp_min(center_bin - radius, 1)[..., None]
    hi = torch.clamp_max(center_bin + radius, SPECTRUM_SIZE - 1)[..., None]
    return torch.sum(torch.where((k >= lo) & (k <= hi), spectrum,
                                 torch.zeros_like(spectrum)), dim=-1)


def interpret(result: AnalysisResult, sample_rate) -> MusicalContext:
    """MusicalInterpreter::interpret (MusicalInterpreter.mm:14-81)."""
    dev = result.rms.device
    sample_rate = torch.tensor(float(sample_rate), dtype=torch.float32,
                               device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    energy = torch.minimum(one, result.rolling_avg * ENERGY_SCALE)

    bass = torch.sqrt(torch.clamp_min(result.bass * BASS_BOOST, 0.0))
    mid = torch.sqrt(torch.clamp_min(result.mid * MID_BOOST, 0.0))
    treble = torch.sqrt(torch.clamp_min(result.treble * TREBLE_BOOST, 0.0))
    total = bass + mid + treble
    brightness = torch.where(total > EPS,
                             treble / torch.clamp_min(total, EPS), 0.5 * one)

    pitch = result.pitch_hz
    conf = result.pitch_confidence
    use_pitch = ((conf >= PITCH_CONFIDENCE_THRESHOLD) & (pitch >= PITCH_MIN)
                 & (pitch <= PITCH_MAX))

    minor_freq = pitch * (2.0 ** (3.0 / 12.0))
    major_freq = pitch * (2.0 ** (4.0 / 12.0))

    def to_bin(f):     # truncates toward zero, as astype(int32)
        return (f * FFT_SIZE / sample_rate).to(torch.int32)

    minor_e = _sum_around_bin(result.spectrum, to_bin(minor_freq))
    major_e = _sum_around_bin(result.spectrum, to_bin(major_freq))
    ratio = minor_e / (major_e + minor_e + EPS)
    mel_pitch = torch.clamp(
        0.6 * ratio + 0.2 * (1.0 - brightness) + 0.2 * (1.0 - energy),
        0.0, 1.0)
    mel_fallback = 0.5 * (1.0 - brightness) + 0.5 * (1.0 - energy)
    melancholy = torch.where(use_pitch, mel_pitch, mel_fallback)

    return MusicalContext(
        energy=energy, brightness=brightness, melancholy=melancholy,
        dominant_pitch=pitch, pitch_confidence=conf)


# --- the audio -> visual mapping (mtl_engine.mm:715-762) --------------------

REF_FREQ = 55.0                  # kRefFreq (mtl_engine.mm:719)
CONFIDENCE_THRESHOLD = 0.25      # :720
VOLUME_THRESHOLD = 0.003         # :721
MIN_PITCH = 50.0                 # :722
MAX_PITCH = 2000.0               # :723
BRIGHTNESS_FLOOR = 0.08          # :745
DECAY_FACTOR = 0.96              # :746
DISPLACEMENT_SCALE = 25.0        # :761
INITIAL_ENVELOPE = 0.3           # mtl_engine.hpp:159


def hue_to_rgb(hue):
    """hueToRGB (mtl_engine.mm:10-25): six-sector piecewise map;
    f32[...] -> f32[..., 3]."""
    h = hue * 6.0
    i = torch.remainder(torch.floor(h).to(torch.int32), 6)
    f = h - torch.floor(h)
    q = 1.0 - f
    t = f
    one = torch.ones_like(f)
    zero = torch.zeros_like(f)

    def select(choices):
        out = one / 3
        for k in reversed(range(6)):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([one, q, zero, zero, t, one]),
                        select([t, one, one, q, zero, zero]),
                        select([zero, zero, t, one, one, q])], dim=-1)


@dataclasses.dataclass(frozen=True)
class VisualState:
    """Cross-frame carry: the peak-hold brightness envelope (on the host)."""

    brightness_envelope: torch.Tensor = INITIAL_ENVELOPE

    @staticmethod
    def init():
        return VisualState(brightness_envelope=torch.tensor(
            INITIAL_ENVELOPE, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class VisualParams:
    """Per-frame scene parameters derived from audio."""

    light_color: torch.Tensor      # f32[..., 3]
    light_intensity: torch.Tensor  # f32[...] (the envelope brightness)
    displacement: torch.Tensor     # f32[...] vertex displacement scalar

    def frame(self, i):
        """Frame ``i`` of a track's parameters."""
        return VisualParams(self.light_color[i], self.light_intensity[i],
                            self.displacement[i])

    def to(self, device):
        return VisualParams(self.light_color.to(device),
                            self.light_intensity.to(device),
                            self.displacement.to(device))


def _envelope(start, raw):
    """envelope_t = max(raw_t, envelope_{t-1} * 0.96), in order, float32,
    on the host. raw: f32[n] numpy."""
    env = np.float32(start)
    decay = np.float32(DECAY_FACTOR)
    out = np.empty_like(raw)
    for i in range(raw.shape[0]):
        env = max(raw[i], env * decay)
        out[i] = env
    return out


def map_audio_to_visual(state: VisualState, ctx: MusicalContext,
                        rms, rolling_avg):
    """mtl_engine.mm:715-762. Returns (new_state, VisualParams)."""
    dev = ctx.energy.device
    rms = torch.as_tensor(rms, dtype=torch.float32, device=dev)
    rolling_avg = torch.as_tensor(rolling_avg, dtype=torch.float32,
                                  device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    # Pitched hue.
    semitones = 12.0 * torch.log2(
        torch.clamp_min(ctx.dominant_pitch, 1e-6) / REF_FREQ)
    hue_p = semitones / 12.0 + 0.08 * (1.0 - ctx.melancholy)
    hue_p = torch.remainder(hue_p, 1.0)
    hue_p = torch.where(hue_p < 0.0, hue_p + 1.0, hue_p)
    # Unpitched fallback hue.
    hue_f = 0.55 + 0.15 * (1.0 - ctx.melancholy)
    hue_f = torch.where(hue_f > 1.0, hue_f - 1.0, hue_f)

    pitched = ((ctx.pitch_confidence >= CONFIDENCE_THRESHOLD)
               & (ctx.dominant_pitch >= MIN_PITCH)
               & (ctx.dominant_pitch <= MAX_PITCH))
    rgb = torch.where(pitched[..., None], hue_to_rgb(hue_p),
                      hue_to_rgb(hue_f))
    rgb = torch.where((rms > VOLUME_THRESHOLD)[..., None], rgb,
                      (one / 3.0).expand(3))

    raw = torch.minimum(one, (ctx.energy * 0.7 + ctx.brightness * 0.3) * 3.0)
    env = _envelope(float(state.brightness_envelope),
                    raw.reshape(-1).cpu().numpy())      # the one copy out
    envelope = torch.from_numpy(env).to(dev).reshape(raw.shape)
    brightness = torch.clamp_min(envelope, BRIGHTNESS_FLOOR)

    new_state = VisualState(brightness_envelope=torch.tensor(
        float(env[-1]), dtype=torch.float32))
    return new_state, VisualParams(
        light_color=rgb * brightness[..., None],
        light_intensity=brightness,
        displacement=rolling_avg * DISPLACEMENT_SCALE,
    )


def track(samples, sample_rate, round_to=None):
    """A whole mono signal f32[n * 1024] -> its n frames' visual
    parameters, numpy float32 on the host: (light_color [n, 3],
    light_intensity [n], displacement [n]). The analyzer's and the
    envelope's carries start fresh, as a new stream's do. ``round_to``: the
    control's precision (see ``frame.rounder``), applied to the parameters."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    n = x.shape[0] // FFT_SIZE
    chunks = x[:n * FFT_SIZE].reshape(n, FFT_SIZE)
    rms = torch.sqrt(torch.mean(torch.square(chunks), dim=-1))
    _, res = _analyze(AnalyzerState.init(), rms, chunks, sample_rate,
                      hann_norm_window())
    ctx = interpret(res, sample_rate)
    _, p = map_audio_to_visual(VisualState.init(), ctx, res.rms,
                               res.rolling_avg)
    out = (p.light_color, p.light_intensity, p.displacement)
    if round_to is not None:
        out = tuple(t.to(round_to).to(torch.float32) for t in out)
    return tuple(t.numpy() for t in out)
