"""The audio track's sequential carries on the card: ``csrc/track.cu``.

``carries`` runs ``track_carries_kernel`` (the rolling RMS window and the
band EMAs over a call's chunks) and ``envelope`` runs
``track_envelope_kernel`` (the peak-hold brightness envelope), each one
launch on PyTorch's current stream, with no sync and no upload, so the
track's CUDA graph captures them (``audio/track.py``). Their plain twins
are the numpy loops ``analyzer._carries`` and ``mapping._envelope``, which
``analyzer.carries`` and ``mapping.envelope`` run for tensors off the
card; the kernels are bit-equal to them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..raster import _build

# Launch count of each kernel; the wrapper adds one per launch (a graph's
# replay runs its captured launches uncounted).
LAUNCHES = {"track_carries": 0, "track_envelope": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    lib = _build.load_library()
    lib.mr_track_carries.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.mr_track_envelope.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.mr_track_carries, lib.mr_track_envelope):
        fn.restype = ctypes.c_int
    return lib


def carries(state, scalars, alpha, keep):
    """The carries of ``scalars`` f32[n, 4] (each chunk's RMS and raw bass,
    mid, treble) from the analyzer ``state`` f32[STATE_LEN]
    (``AnalyzerState.pack``'s layout), both on the card: (the new state
    f32[STATE_LEN], the carried values f32[n, 4]: the rolling average read
    before each chunk's push and the smoothed bands after it). ``alpha``,
    ``keep``: the EMA's weights as float32 values."""
    device = scalars.device
    n = scalars.shape[0]
    _build.check("state", state, torch.float32, device, state.shape)
    _build.check("scalars", scalars, torch.float32, device, (n, 4))
    new = torch.empty_like(state)
    carried = torch.empty_like(scalars)
    p = _build.ptr
    err = _lib().mr_track_carries(p(state), p(new), p(scalars), p(carried),
                                  n, alpha, keep, _build.stream(device))
    _build.raise_on(err, "track_carries")
    LAUNCHES["track_carries"] += 1
    return new, carried


def envelope(start, raw, decay):
    """The peak-hold envelope of ``raw`` f32[n] from ``start`` f32[1], both
    on the card: f32[n + 1], ``start`` first and each chunk's envelope
    after it. ``decay``: the factor as a float32 value."""
    device = raw.device
    n = raw.shape[0]
    _build.check("start", start, torch.float32, device, (1,))
    _build.check("raw", raw, torch.float32, device, (n,))
    env = torch.empty((n + 1,), dtype=torch.float32, device=device)
    p = _build.ptr
    err = _lib().mr_track_envelope(p(start), p(raw), p(env), n, decay,
                                   _build.stream(device))
    _build.raise_on(err, "track_envelope")
    LAUNCHES["track_envelope"] += 1
    return env
