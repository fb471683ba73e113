"""Deciding ``correct``: what the window produced, held against the plain
reference (``gpubench/reference``) worked out again from the same inputs.

* ``frame_mae``: the largest, over the checked frames, of the mean absolute
  difference between the program's rgba frame and the reference's, over
  every pixel and channel. The checked frames are every frame of a sample
  of the window's requests, drawn from the seed (``Reservoir``).
* ``tile_mae``: the largest, over the checked frames and over their
  ``TILE`` x ``TILE``-pixel tiles, of that mean taken over one tile. A
  wrong area too small to move the frame's mean (one wrong pixel of a 4K
  frame) moves its tile's as many times more as the frame has tiles.
* ``track_max_abs`` (audio cells): the largest absolute difference, over
  every frame of the window, between the program's audio-track parameters
  (the light color, the light intensity, the displacement) and the
  reference track's.
* ``intensity_clamped_share`` (audio cells): the share of the window's
  frames whose light intensity the program put at its clamp of 1. Not a
  gap but a guard on the traffic: a signal so loud that the light sits at
  the clamp never drives the envelope and its decay that
  ``track_max_abs`` is there to hold.

A request fails when one of its numbers passes its limit; a frame that
never came (a request that did not finish) fails too. The reference runs
once the window has closed and the program's state is freed, on the same
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import inputs

TILE = 8  # pixels a side of ``tile_mae``'s tiles
# The light brightness's min(1, ...) (mtl_engine.mm:715-762).
INTENSITY_CLAMP = 1.0


class Reservoir:
    """A uniform sample of ``k`` requests from a window of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = inputs.rng(seed, inputs.CHECK_STREAM)
        self.kept = {}   # request index -> frames
        self.seen = 0

    def offer(self, i, frames):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[i] = frames
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = frames


def frame_gaps(prog, ref):
    """(frame_mae, tile_mae) of one rgba frame f32[H, W, 4] against the
    reference's; a gap that is not finite reads as infinity."""
    d = torch.abs(prog.float() - ref)
    tiles = torch.nn.functional.avg_pool2d(
        d.permute(2, 0, 1)[None], TILE, ceil_mode=True).mean(dim=1)
    gaps = (float(d.mean()), float(tiles.max()))
    return tuple(g if np.isfinite(g) else np.inf for g in gaps)


def reference_track(traffic, audio, round_to=None):
    from ..reference import audio as ref_audio
    return ref_audio.track(audio, float(traffic["sample_rate"]), round_to)


def reference_frame(config, mesh_arrays, frame_inputs, device,
                    round_to=None, count=False):
    """One frame by the reference. ``frame_inputs``: {"displacement": d}
    and, where the light follows the audio, {"light_color": rgb,
    "light_intensity": x}; where the camera orbits, {"theta": t}."""
    from ..reference import frame as ref_frame, scene as ref_scene
    instances, camera, lighting, render, shadow, target = ref_scene.build(
        config, mesh_arrays,
        light_color=frame_inputs.get("light_color"), device=device)
    if "theta" in frame_inputs:
        camera = dataclasses.replace(camera, theta=frame_inputs["theta"])
    if "light_intensity" in frame_inputs:
        lighting = ref_scene.Lighting(
            ref_scene.PointLight(lighting.light.position,
                                 frame_inputs["light_color"],
                                 frame_inputs["light_intensity"]),
            lighting.ambient_intensity, lighting.shininess)
    return ref_frame.render(instances, camera, lighting, render, shadow,
                            frame_inputs["displacement"], target, device,
                            round_to=round_to, count=count,
                            textures=ref_scene.texture_chains(mesh_arrays,
                                                              device))


def reference_arrays(mesh_arrays):
    """``mesh_arrays`` with each OBJ mesh's arrays as the reference's own
    reader (``reference.obj``) reads them back from its file; raises where
    they differ, bit for bit, from the arrays the file was written
    from."""
    from ..reference import obj as ref_obj
    out = dict(mesh_arrays)
    for i, path in mesh_arrays.get("obj_files", {}).items():
        out[i] = ref_obj.load(path)
        inputs.same_bits(out[i], mesh_arrays[i],
                         f"reference.obj.load({path!r})")
    return out


def frame_inputs(first, count, track):
    """The reference's inputs of frames ``first`` .. ``first+count-1`` of
    an audio cell, from its track (color [n, 3], intensity [n],
    displacement [n])."""
    color, intensity, disp = track
    return [{"light_color": tuple(float(c) for c in color[f]),
             "light_intensity": float(intensity[f]),
             "displacement": float(disp[f])}
            for f in range(first, first + count)]


def compare(config, mesh_arrays, traffic, driver, kept, track_parts,
            limits, device, want_counts=False):
    """The compared numbers, the failed requests and (``want_counts``) the
    mean fragments a frame needs. ``kept``: {request: frames on the
    device}; ``track_parts``: the program's per-request track parameters
    (audio cells) or None."""
    per = int(traffic["frames_per_request"])
    numbers, failed = {}, set()
    track = None
    if track_parts is not None:
        prog = track_parts
        n_frames = prog[0].shape[0]
        track = reference_track(traffic, driver.audio(n_frames))
        gap = np.zeros(n_frames, np.float64)
        for p, r in zip(prog, track):
            d = np.abs(p.astype(np.float64) - r[:n_frames].astype(np.float64))
            gap = np.maximum(gap, d.reshape(n_frames, -1).max(axis=1))
        gap = np.where(np.isfinite(gap), gap, np.inf)
        numbers["track_max_abs"] = float(gap.max()) if n_frames else np.inf
        for f in np.nonzero(gap > limits["track_max_abs"])[0]:
            failed.add(int(f) // per)
        numbers["intensity_clamped_share"] = float(np.mean(
            prog[1] >= INTENSITY_CLAMP)) if n_frames else np.inf
    worst = {"frame_mae": 0.0, "tile_mae": 0.0}
    counts = []
    if kept:
        mesh_arrays = reference_arrays(mesh_arrays)
    for i in sorted(kept):
        frames = kept[i]
        ins = (frame_inputs(i * per, per, track) if track is not None
               else driver.frame_inputs(i * per, per))
        for k, fi in enumerate(ins):
            out = reference_frame(config, mesh_arrays, fi, device,
                                  count=want_counts)
            if want_counts:
                out, c = out
                counts.append(c)
            gaps = frame_gaps(frames[k].to(device), out)
            for name, g in zip(("frame_mae", "tile_mae"), gaps):
                worst[name] = max(worst[name], g)
                if g > limits[name]:
                    failed.add(i)
            del out
    for name in worst:
        numbers[name] = worst[name] if kept else np.inf
    mean_counts = None
    if counts:
        mean_counts = {k: float(np.mean([c[k] for c in counts]))
                       for k in counts[0]}
    return numbers, failed, mean_counts
