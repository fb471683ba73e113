"""Audio -> visual mapping: pitch-to-hue light color, peak-hold brightness
envelope, vertex displacement scalar.

Torch counterpart of ``metalrenderer_tpu.audio.mapping``, itself a port of
the per-frame logic in MtlEngine::updateSharedTransformData
(mtl_engine.mm:715-762) and hueToRGB (mtl_engine.mm:10-25), with the
reference's exact constants:

  * hue = semitones-from-A1(55 Hz)/12 + 0.08*(1-melancholy), wrapped,
    gated by rms > 0.003, confidence >= 0.25, 50..2000 Hz; low-confidence
    fallback hue 0.55 + 0.15*(1-melancholy); silence -> gray 1/3.
  * brightness envelope: instant attack to min(1, (0.7*energy +
    0.3*brightness)*3), decay *0.96, floor 0.08 (mtl_engine.mm:745-752,
    mtl_engine.hpp:158-159 initial 0.3).
  * lightColor = hueRGB * brightness; displacement = rollingAvg * 25
    (mtl_engine.mm:753, :761).

``map_audio_to_visual`` takes one frame (0-d leaves) or a whole track
(leaves with a leading frame axis). The envelope is a sequential carry: it
runs on the host in float32, in frame order, on the frames' raw values
brought over in one copy (as the analyzer's carries do), and the state
lives on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import annotate
from .interpreter import MusicalContext

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
    with annotate("mr/track/sync"):
        raw_host = raw.reshape(-1).cpu().numpy()        # the one copy out
    env = _envelope(float(state.brightness_envelope), raw_host)
    envelope = torch.from_numpy(env).to(dev).reshape(raw.shape)
    brightness = torch.clamp_min(envelope, BRIGHTNESS_FLOOR)

    new_state = VisualState(brightness_envelope=torch.tensor(
        float(env[-1]), dtype=torch.float32))
    return new_state, VisualParams(
        light_color=rgb * brightness[..., None],
        light_intensity=brightness,
        displacement=rolling_avg * DISPLACEMENT_SCALE,
    )
