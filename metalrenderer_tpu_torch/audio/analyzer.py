"""Audio analysis pipeline (torch counterpart of
``metalrenderer_tpu.audio.analyzer``, itself a port of AudioAnalyzer.{hpp,mm}).

Analysis is a pure function over 1024-sample chunks with an explicit state.
A whole signal is analyzed in two parts:

* the per-chunk features that need no history (RMS, the windowed spectrum,
  the raw band sums, the pitch) are computed for all chunks at once on
  [n, 1024] tensors on the render device; the two FFTs are ``torch.fft``
  (cuFFT on the card), as the JAX package takes them from XLA outside any
  Pallas kernel;
* the sequential carries (the 120-entry rolling RMS sum and the three band
  EMAs) run strictly in chunk order in float32, as the JAX ``lax.scan``
  does: a cumulative-sum rewrite would round differently. On the card they
  are one launch of ``track_carries_kernel`` (``csrc/track.cu``), on the
  device state packed as one vector (``AnalyzerState.pack``), so nothing
  waits for the host; elsewhere its twin, the numpy loop ``_carries``. The
  state a caller holds lives on the host (CPU tensors): ``analyze_stream``
  reads the new state back in one copy at its end.

Faithful semantics (citations):
  * RMS over all channels (AudioAnalyzer.mm:49-65).
  * rollingAvg is the 120-entry window average BEFORE pushing the current
    chunk's RMS (processBuffer order, AudioAnalyzer.mm:28-31).
  * Spectrum: 1024-pt Hann(normalized)-windowed real FFT via vDSP
    ``fft_zrip`` whose packed output is 2x the mathematical DFT, then
    scaled by 2/N (AudioAnalyzer.mm:67-96) => magnitude[k] = 4|DFT_k|/N.
    (Bins 0 and 512 are the plain |DFT| values; no feature reads them.)
  * Band energies bass<155 Hz, mid<880, treble<4186, EMA alpha = 0.15
    (AudioAnalyzer.mm:102-127, AudioAnalyzer.hpp:61). Bin edges truncate
    toward zero in float32.
  * Pitch: normalized autocorrelation over the WINDOWED buffer, lag range
    sr/1500..sr/50 (truncated), confidence = best correlation, the first
    strict maximum wins (AudioAnalyzer.mm:129-166): one FFT autocorrelation
    and a prefix sum. A smooth low tone (110 Hz) is mis-detected at the
    minimum lag, as in the reference; this is reproduced, not repaired.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..passes.pipeline import resolve_device
from ..utils.profiling import annotate
from . import track_cuda

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
_ALPHA, _KEEP = _F32(BAND_SMOOTH_ALPHA), _F32(1 - BAND_SMOOTH_ALPHA)

# ``AnalyzerState.pack``'s layout, which csrc/track.cu reads: the ring, the
# running sum, the smoothed bass, mid and treble, the next write slot and
# the count.
_SUM = ROLLING_WINDOW
_BANDS = ROLLING_WINDOW + 1
_IDX = ROLLING_WINDOW + 4
_COUNT = ROLLING_WINDOW + 5
STATE_LEN = ROLLING_WINDOW + 6


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
class Constants:
    """What a track call on one device reads of its sample rate and the FFT
    size, formed once per (device, sample rate) (``constants``), so no op
    of a call uploads anything."""

    window: torch.Tensor     # f32[1024] hann_norm_window
    rate: torch.Tensor       # f32[] the sample rate
    zero: torch.Tensor       # f32[] 0
    lags: torch.Tensor       # i64[1024] 0..1023
    below: torch.Tensor      # i64[1024] clamp(N - lag - 1): i < N - lag
    before: torch.Tensor     # i64[1024] clamp(lag - 1): i < lag
    in_range: torch.Tensor   # bool[1024] the pitch's lag range


@functools.lru_cache(maxsize=16)
def _constants(device, sample_rate):
    n = FFT_SIZE
    lags = torch.arange(n, device=device)
    min_lag = max(_trunc_div(sample_rate, PITCH_MAX_HZ), 1)
    max_lag = min(_trunc_div(sample_rate, PITCH_MIN_HZ), n - 1)
    return Constants(
        window=hann_norm_window(n, device),
        rate=torch.tensor(sample_rate, dtype=torch.float32, device=device),
        zero=torch.zeros((), dtype=torch.float32, device=device), lags=lags,
        below=torch.clamp(n - lags - 1, 0, n - 1),
        before=torch.clamp(lags - 1, 0, n - 1),
        in_range=(lags >= min_lag) & (lags <= max_lag))


def constants(device, sample_rate) -> Constants:
    """The ``Constants`` of ``device`` and ``sample_rate``, made at the
    first call of the pair (16 pairs are kept; a track graph holds its
    own)."""
    return _constants(torch.device(device), float(sample_rate))


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

    def pack(self):
        """The state as one f32[STATE_LEN] host vector, the carries
        kernel's layout: the ring, the running sum, the three EMAs, then
        the write slot and the count as floats (exact)."""
        tail = torch.tensor([float(v) for v in (
            self.rolling_sum, self.smoothed_bass, self.smoothed_mid,
            self.smoothed_treble, self.rolling_idx, self.rolling_count)],
            dtype=torch.float32)
        return torch.cat([torch.as_tensor(self.rolling, dtype=torch.float32)
                          .reshape(-1).cpu(), tail])

    @staticmethod
    def unpack(vec):
        """The state reading ``vec``, a host vector in ``pack``'s layout."""
        return AnalyzerState(
            rolling=vec[:ROLLING_WINDOW],
            rolling_idx=torch.tensor(int(vec[_IDX]), dtype=torch.int32),
            rolling_count=torch.tensor(int(vec[_COUNT]), dtype=torch.int32),
            rolling_sum=vec[_SUM], smoothed_bass=vec[_BANDS],
            smoothed_mid=vec[_BANDS + 1], smoothed_treble=vec[_BANDS + 2])


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
    k = constants(x.device, sample_rate)
    f = torch.fft.rfft(x, 2 * n)
    ac = torch.fft.irfft(f * torch.conj(f), 2 * n)[..., :n].to(torch.float32)

    c = torch.cumsum(x * x, dim=-1)
    total = c[..., n - 1:n]
    sum_x2 = c[..., k.below]                                  # i < N-lag
    sum_y2 = total - torch.where(k.lags > 0, c[..., k.before], k.zero)

    denom = torch.sqrt(sum_x2 * sum_y2)
    corr = torch.where(denom > 1e-10, ac / torch.clamp_min(denom, 1e-30),
                       torch.zeros_like(ac))

    min_lag = max(_trunc_div(sample_rate, PITCH_MAX_HZ), 1)
    max_lag = min(_trunc_div(sample_rate, PITCH_MIN_HZ), n - 1)
    corr_m = torch.where(k.in_range, corr, torch.full_like(corr, -torch.inf))
    best_lag = torch.argmax(corr_m, dim=-1)   # first strict max, like the loop
    best_corr = torch.gather(corr_m, -1, best_lag[..., None])[..., 0]

    if not min_lag < max_lag:
        zero = torch.zeros_like(best_corr)
        return zero, zero
    # A tensor numerator: a Python number over a tensor multiplies by the
    # reciprocal, which rounds twice.
    pitch = k.rate / best_lag.to(torch.float32)
    return pitch, torch.clamp(best_corr, 0.0, 1.0)


def _carries(state: AnalyzerState, rms, bands):
    """The sequential part, on the host in float32, in chunk order: the
    rolling RMS window (RollingAverage::push, AudioAnalyzer.hpp:37-49:
    append until full, then overwrite round-robin; the average is read
    BEFORE the push) and the band EMAs. rms: f32[n], bands: f32[n, 3]
    numpy. Returns (new state, rolling_avg f32[n], smoothed f32[n, 3]).
    The plain twin of ``track_carries_kernel``."""
    rolling = state.rolling.numpy().copy()
    idx, count = int(state.rolling_idx), int(state.rolling_count)
    total = _F32(state.rolling_sum.item())
    sm = [_F32(state.smoothed_bass.item()), _F32(state.smoothed_mid.item()),
          _F32(state.smoothed_treble.item())]
    a, keep = _ALPHA, _KEEP
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


def carries(state, scalars):
    """A call's carries in chunk order: ``state`` f32[STATE_LEN]
    (``AnalyzerState.pack``'s layout) and ``scalars`` f32[n, 4] (each
    chunk's RMS and raw bass, mid, treble) on one device -> (the new state
    f32[STATE_LEN], f32[n, 4]: the rolling average read before each chunk's
    push, the smoothed bass, mid, treble after it). On the card one launch
    of ``track_carries_kernel``; elsewhere the numpy loop ``_carries``."""
    if scalars.device.type == "cuda":
        return track_cuda.carries(state, scalars, float(_ALPHA),
                                  float(_KEEP))
    scalars = scalars.numpy()
    new, avg, smoothed = _carries(AnalyzerState.unpack(state),
                                  scalars[:, 0], scalars[:, 1:])
    return new.pack(), torch.from_numpy(
        np.concatenate([avg[:, None], smoothed], axis=1))


def analyze(state, rms, ch0, sample_rate, window=None):
    """Chunks ch0 f32[n, 1024] with their RMS f32[n] from the packed
    ``state`` f32[STATE_LEN], all on one device: (the new packed state,
    AnalysisResult), with no sync and no upload on the card. ``window``:
    the spectrum's window on that device (default the Hann window)."""
    if window is None:
        window = constants(ch0.device, sample_rate).window
    spectrum, windowed = compute_spectrum(ch0, window)
    pitch, conf = pitch_mpm(windowed, sample_rate)
    scalars = torch.stack([rms, *band_energies(spectrum, sample_rate)],
                          dim=-1)
    state, carried = carries(state, scalars)
    return state, AnalysisResult(
        rms=rms, rolling_avg=carried[:, 0], spectrum=spectrum,
        bass=carried[:, 1], mid=carried[:, 2], treble=carried[:, 3],
        pitch_hz=pitch, pitch_confidence=conf)


def _analyze(state: AnalyzerState, rms, ch0, sample_rate, window=None):
    """``analyze`` from and to a host ``AnalyzerState``: one upload of the
    state, one read of the new state at the end."""
    vec, res = analyze(state.pack().to(ch0.device), rms, ch0, sample_rate,
                       window)
    with annotate("mr/track/sync"):
        vec = vec.cpu()                                     # the one copy out
    return AnalyzerState.unpack(vec), res


def process_chunk(state: AnalyzerState, samples, sample_rate, window=None,
                  device="cuda"):
    """One 1024-frame buffer through the full pipeline.

    samples: f32[1024] mono or f32[C, 1024] multichannel (RMS uses all
    channels; spectrum/pitch use channel 0, AudioAnalyzer.mm:71-73).
    Returns (new_state, AnalysisResult of 0-d and [513] leaves on
    ``device``)."""
    device = resolve_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float32).to(device)
    ch0 = samples[0] if samples.dim() == 2 else samples
    rms = torch.sqrt(torch.mean(torch.square(samples)))
    state, res = _analyze(state, rms[None], ch0[None], sample_rate, window)
    return state, AnalysisResult(**{
        f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def analyze_stream(samples, sample_rate, state: AnalyzerState = None,
                   device="cuda"):
    """Analyze a whole mono signal in frames of 1024. samples:
    f32[num_frames*1024] (a trailing remainder is dropped, like the
    reference's frameLength check at AudioAnalyzer.mm:69). Returns
    (final_state, AnalysisResult with a leading chunk axis, on ``device``)."""
    device = resolve_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float32).to(device)
    n_chunks = samples.shape[0] // FFT_SIZE
    chunks = samples[:n_chunks * FFT_SIZE].reshape(n_chunks, FFT_SIZE)
    if state is None:
        state = AnalyzerState.init()
    rms = torch.sqrt(torch.mean(torch.square(chunks), dim=-1))
    return _analyze(state, rms, chunks, sample_rate)
