"""K7: single-channel bilinear sampling, a CUDA kernel with its plain twin.

``sample_bilinear`` replaces ``metalrenderer_tpu/raster/sample_pallas.py``
``sample_bilinear_tiled`` (-> ``_sample_padded``): a single-channel texture
f32[TH, TW] sampled at f32 ``u, v`` grids with ``sampling.sample_bilinear``
semantics (half-texel centres, REPEAT or CLAMP addressing); pixels outside
``mask`` read ``oob_value``. The split path's shadow test is its caller.

The Pallas kernel DMAs a window of the texture per 8x128 tile and sweeps
segments for footprints beyond it; the CUDA kernel (``csrc/sample.cu``)
reads the four taps of each pixel straight from the whole texture, which
stays in L2. It is bound by the bytes of its per-pixel planes; see the
source's header.
"""
from __future__ import annotations

import functools

import ctypes
import torch

from . import _build, sampling
from .sampling import REPEAT

# Launch count of the kernel; the wrapper adds one per launch.
LAUNCHES = {"sample_bilinear": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sample_bilinear_plain(tex, u, v, address_mode=REPEAT, oob_value=0.0,
                          mask=None):
    """Plain PyTorch twin of the kernel (same inputs, same arithmetic)."""
    if mask is None:
        return sampling.sample_bilinear(tex[..., None], u, v,
                                        address_mode)[..., 0]
    zero = torch.zeros_like(u)
    d = sampling.sample_bilinear(tex[..., None], torch.where(mask, u, zero),
                                 torch.where(mask, v, zero),
                                 address_mode)[..., 0]
    return torch.where(mask, d, torch.full_like(d, oob_value))


@functools.cache
def _lib():
    lib = _build.load_library()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mr_sample_bilinear.argtypes = [P, I, I, P, P, P, F, I, I, P, P]
    lib.mr_sample_bilinear.restype = I
    return lib


def sample_bilinear(tex, u, v, address_mode=REPEAT, oob_value=0.0,
                    mask=None):
    """Bilinear sample of ``tex`` f32[TH, TW] at ``u, v`` f32[...] (kernel
    K7); ``mask`` bool[...] or None (every pixel). Returns f32 shaped like
    ``u``. CPU tensors go to the plain twin; CUDA tensors launch the kernel,
    and a failed launch raises."""
    if tex.dim() != 2:
        raise ValueError("tex: need a 2-D [H, W] texture")
    if u.shape != v.shape or (mask is not None and mask.shape != u.shape):
        raise ValueError("u, v and mask must have one shape")
    if address_mode not in (REPEAT, sampling.CLAMP):
        raise ValueError(f"unknown address mode {address_mode!r}")
    device = tex.device
    if device.type == "cpu":
        return sample_bilinear_plain(tex, u, v, address_mode, oob_value, mask)
    _build.check("tex", tex, torch.float32, device)
    _build.check("u", u, torch.float32, device)
    _build.check("v", v, torch.float32, device)
    if mask is not None:
        _build.check("mask", mask, torch.bool, device)
    out = torch.empty_like(u)
    th, tw = tex.shape
    err = _lib().mr_sample_bilinear(
        _build.ptr(tex), th, tw, _build.ptr(u), _build.ptr(v),
        _build.ptr(mask), float(oob_value), int(address_mode == REPEAT),
        u.numel(), _build.ptr(out), _build.stream(device))
    _build.raise_on(err, "sample_bilinear")
    LAUNCHES["sample_bilinear"] += 1
    return out
