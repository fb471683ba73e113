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
(leaves with a leading frame axis). The envelope is a sequential carry in
float32, in frame order: on the card one launch of
``track_envelope_kernel`` (``csrc/track.cu``), elsewhere its twin, the
numpy loop ``_envelope``. The state a caller holds lives on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import annotate
from . import track_cuda
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
_DECAY = np.float32(DECAY_FACTOR)


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
    on the host. raw: f32[n] numpy. The plain twin of
    ``track_envelope_kernel``."""
    env = np.float32(start)
    decay = _DECAY
    out = np.empty_like(raw)
    for i in range(raw.shape[0]):
        env = max(raw[i], env * decay)
        out[i] = env
    return out


def envelope(start, raw):
    """The envelope of ``raw`` f32[n] from ``start`` f32[1], on one device:
    f32[n + 1], ``start`` first, then each frame's envelope. On the card
    one launch of ``track_envelope_kernel``; elsewhere the numpy loop
    ``_envelope``."""
    if raw.device.type == "cuda":
        return track_cuda.envelope(start, raw, float(_DECAY))
    return torch.from_numpy(np.concatenate(
        [start.numpy(), _envelope(float(start[0]), raw.numpy())]))


def map_audio_to_visual(state: VisualState, ctx: MusicalContext,
                        rms, rolling_avg):
    """mtl_engine.mm:715-762. Returns (new_state, VisualParams); the new
    state is the one read to the host."""
    start = torch.as_tensor(state.brightness_envelope, dtype=torch.float32)
    env, params = visual_params(start.reshape(1).to(ctx.energy.device), ctx,
                                rms, rolling_avg)
    with annotate("mr/track/sync"):
        last = env[-1].cpu()                                # the one copy out
    return VisualState(brightness_envelope=last), params


def visual_params(start, ctx: MusicalContext, rms, rolling_avg):
    """``map_audio_to_visual`` from the envelope ``start`` f32[1] on the
    context's device, with no sync and no upload on the card: (the
    envelope f32[n + 1] (``envelope``; its last value is the new state's),
    VisualParams)."""
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
    env = envelope(start, raw.reshape(-1))
    brightness = torch.clamp_min(env[1:].reshape(raw.shape), BRIGHTNESS_FLOOR)
    return env, VisualParams(
        light_color=rgb * brightness[..., None],
        light_intensity=brightness,
        displacement=rolling_avg * DISPLACEMENT_SCALE,
    )
