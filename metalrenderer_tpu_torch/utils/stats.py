"""Telemetry — the ImGui overlay (mtl_engine.mm:880-933) as data; the
port's own copy of ``metalrenderer_tpu.utils.stats``.

The reference displays FPS, RMS, rolling average, a 20-4180 Hz spectrum
plot, band energies, pitch/confidence and the MusicalContext live in an
ImGui panel. Here the same telemetry is a returned stats dict per frame plus
host-side aggregation helpers; ``to_json`` replaces the panel, and
``spectrum_rows`` reproduces the overlay's plotted frequency range. Tensors
on any device come to the host as numpy arrays (``to_numpy``).
"""
from __future__ import annotations

import json
import time

import numpy as np

# ImGui spectrum plot range (mtl_engine.mm:902-916).
SPECTRUM_LO_HZ = 20.0
SPECTRUM_HI_HZ = 4180.0
# Display boost factors for band bars (mtl_engine.mm:921-924).
DISPLAY_BASS_BOOST = 5.0
DISPLAY_MID_BOOST = 0.8
DISPLAY_TREBLE_BOOST = 3.0


def to_numpy(x):
    """A tensor on any device (or an array-like) as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def spectrum_rows(spectrum, sample_rate, fft_size=1024):
    """Slice the magnitude spectrum to the overlay's 20-4180 Hz window.

    spectrum: [..., 513]. Returns (frequencies f32[K], magnitudes [..., K]).
    """
    spectrum = to_numpy(spectrum)
    freqs = np.arange(spectrum.shape[-1]) * (sample_rate / fft_size)
    mask = (freqs >= SPECTRUM_LO_HZ) & (freqs <= SPECTRUM_HI_HZ)
    return freqs[mask], spectrum[..., mask]


def display_bands(bass, mid, treble):
    """Band bars with the overlay's display boosts (NOT the interpreter's
    boosts — the reference uses 5.0/0.8/3.0 for display and 5.0/0.8/1.0
    for brightness)."""
    return {
        "bass": float(bass) * DISPLAY_BASS_BOOST,
        "mid": float(mid) * DISPLAY_MID_BOOST,
        "treble": float(treble) * DISPLAY_TREBLE_BOOST,
    }


class FrameClock:
    """Host-side FPS counter (the overlay's 'FPS: %.1f' readout)."""

    def __init__(self, smoothing=0.9):
        self._last = None
        self._fps = 0.0
        self._smoothing = smoothing

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            inst = 1.0 / dt if dt > 0 else 0.0
            self._fps = (self._smoothing * self._fps
                         + (1.0 - self._smoothing) * inst
                         if self._fps else inst)
        self._last = now
        return self._fps

    @property
    def fps(self):
        return self._fps


def to_json(stats, **extra):
    """Structured one-line log record from a stats dict."""
    rec = {k: (to_numpy(v).tolist() if hasattr(v, "shape") else v)
           for k, v in dict(stats).items()}
    rec.update(extra)
    return json.dumps(rec)
