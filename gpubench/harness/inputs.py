"""What the benchmark makes from a cell's traffic file and seed: the audio
signal and the per-frame displacements the window sends, and the dense
sphere's mesh arrays that both the program and the reference read.

One general generator per traffic kind, driven by the parameters in
``traffic/<name>.json``; the seed sets phases and noise, never sizes or
counts, so every seed sends the same amount of work.
"""
from __future__ import annotations

import numpy as np


def rng(seed, stream):
    """A numpy Generator for one use of the seed (``stream`` keeps the
    traffic, the sample of checked requests and the rest apart). Seeds of
    any size are taken whole."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


TRAFFIC_STREAM, CHECK_STREAM = 1, 2


def audio_signal(traffic, buffers, seed):
    """``buffers`` x ``buffer_samples`` mono samples, float32: parts of
    ``part_buffers`` buffers that cycle through a tone at each of
    ``tones_hz`` (a random phase each part, the RMS level of the same place
    in ``tone_rms``), a noise burst (RMS ``noise_rms``) and silence. A copy
    of ``chip_smoke.audio_signal``'s six parts, repeated, so that a window
    of any length hears all of them."""
    r = rng(seed, TRAFFIC_STREAM)
    n = int(traffic["buffer_samples"])
    sr = float(traffic["sample_rate"])
    part = int(traffic["part_buffers"]) * n
    tones = [float(f) for f in traffic["tones_hz"]]
    kinds = len(tones) + 2
    total = buffers * n
    out = np.zeros(total, np.float32)
    t = np.arange(part) / sr
    for k, start in enumerate(range(0, total, part)):
        m = min(part, total - start)
        which = k % kinds
        if which < len(tones):
            seg = np.sqrt(2.0) * traffic["tone_rms"][which] * np.sin(
                2 * np.pi * tones[which] * t[:m] + r.uniform(0, 2 * np.pi))
        elif which == len(tones):
            seg = traffic["noise_rms"] * r.standard_normal(m)
        else:
            continue
        out[start:start + m] = seg
    return out


def audio_window(traffic, warmup_requests, seed):
    """(the window's signal, the warm-up's): the window's holds the most a
    window of ``max_seconds`` at ``max_frames_per_s`` can take, and a whole
    request more; the warm-up plays ``warmup_requests`` requests of its
    own, cut from the end, so the window's stream starts at sample 0."""
    f = int(traffic["frames_per_request"])
    n = int(traffic["buffer_samples"])
    window = int(traffic["max_frames_per_s"] * traffic["max_seconds"]) + f
    warm = int(warmup_requests) * f
    samples = audio_signal(traffic, window + warm, seed)
    return samples[:window * n], samples[window * n:]


def displacements(traffic, first, count, seed):
    """The displacement of frames ``first`` .. ``first + count - 1``:
    ``base + amplitude * sin(2 pi i / period_frames + phase)``, the phase
    drawn from the seed (float32 values as Python floats)."""
    phase = rng(seed, TRAFFIC_STREAM).uniform(0, 2 * np.pi)
    i = np.arange(first, first + count, dtype=np.float64)
    d = traffic["base"] + traffic["amplitude"] * np.sin(
        2 * np.pi * i / traffic["period_frames"] + phase)
    return [float(x) for x in d.astype(np.float32)]


def dense_sphere_arrays(target_tris):
    """A frozen copy of the port's ``engine/configs._dense_sphere_mesh``
    (BASELINE config 5's mesh): a sphere of radius 0.5 with about
    ``target_tris`` triangles (the poles' quads degenerate), float32 numpy
    (positions, uvs, normals), three vertices per triangle."""
    stacks = max(8, int(np.sqrt(target_tris / 4)))
    slices = 2 * stacks
    phi = np.linspace(0, np.pi, stacks + 1)
    th = np.linspace(0, 2 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, th, indexing="ij")
    pts = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), 1 - pp / np.pi], -1).astype(np.float32)

    def quad_corners(a):  # [stacks+1, slices+1, C] -> two tris per quad
        c00, c01, c10, c11 = a[:-1, :-1], a[:-1, 1:], a[1:, :-1], a[1:, 1:]
        t1 = np.stack([c00, c11, c01], axis=2)
        t2 = np.stack([c00, c10, c11], axis=2)
        return np.concatenate([t1, t2], axis=2).reshape(-1, a.shape[-1])

    pos = quad_corners(pts)
    return pos * 0.5, quad_corners(uv), pos


def mesh_arrays(config):
    """{instance index: (pos, uv, nrm)} for the configuration's meshes that
    the benchmark makes (kind ``dense_sphere``)."""
    out = {}
    for i, d in enumerate(config["instances"]):
        if d["mesh"]["kind"] == "dense_sphere":
            out[i] = dense_sphere_arrays(int(d["mesh"]["target_tris"]))
    return out
