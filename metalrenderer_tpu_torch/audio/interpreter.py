"""Musical interpretation (torch counterpart of
``metalrenderer_tpu.audio.interpreter``, itself a port of
MusicalInterpreter.mm and MusicalContext.hpp).

Maps analyzer output to a ``MusicalContext`` {energy, brightness,
melancholy, dominantPitch, pitchConfidence} with the reference's exact
constants: energy = min(1, rollingAvg*150) (MusicalInterpreter.mm:19);
brightness = treble share of sqrt-boosted bands with boosts 5.0/0.8/1.0
(:23-31); melancholy = 0.6*minor-third-ratio + 0.2*darkness + 0.2*quiet
when pitch is confident, else 0.5/0.5 fallback (:42-77). Elementwise: the
result's leaves may carry a leading chunk axis.
"""
from __future__ import annotations

import dataclasses

import torch

from .analyzer import FFT_SIZE, SPECTRUM_SIZE, AnalysisResult, constants

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
    sample_rate = constants(dev, sample_rate).rate
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
