"""K7/K8: single-channel bilinear sampling, a CUDA kernel with its plain twins.

``sample_bilinear`` replaces ``metalrenderer_tpu/raster/sample_pallas.py``
``sample_bilinear_tiled`` (-> ``_sample_padded``): a single-channel texture
f32[TH, TW] sampled at f32 ``u, v`` grids with ``sampling.sample_bilinear``
semantics (half-texel centres, REPEAT or CLAMP addressing); pixels outside
``mask`` read ``oob_value``. The split path's shadow test is its caller.
The grids may have any shape: [S, H, W] sample planes against the one
texture are sampled in one launch over the flattened planes, as one frame
of S*H*W pixels, where the JAX package launches its kernel once per sample
plane.
``sample_bilinear_batch`` (K8) replaces ``sample_bilinear_tiled_batch``
(-> ``_sample_padded_frames``): one texture per frame, f32[F, TH, TW] at
f32[F, H, W] grids in one launch of the same kernel (the batched shadow
test), the frame the grid's z index; each frame is bit-equal to K7 on that
frame.

The Pallas kernel DMAs a window of the texture per 8x128 tile and sweeps
segments for footprints beyond it; the CUDA kernel (``csrc/sample.cu``)
reads the four taps of each pixel straight from the whole texture, which
stays in L2. A thread takes two quads of 4 consecutive pixels, a warp's
width apart: per quad the mask as one 4-byte word, u and v as float4
loads where a pixel of the quad is sampled, its 16 taps in flight with
the other quad's, out as float4 stores, so a pixel's three dependent
memory round trips are paid once per 8 pixels. Each frame's pixels before
its first aligned quad and after its last take scalar accesses, as does a
frame whose ``u``, ``v`` and output are not aligned alike (a view). See
the source's header for the design and what bounds it.
"""
from __future__ import annotations

import functools

import ctypes
import torch

from . import _build, sampling
from .sampling import REPEAT

# Launch count of the kernel; the wrapper adds one per launch.
LAUNCHES = {"sample_bilinear": 0, "sample_bilinear_batch": 0}


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


def sample_bilinear_batch_plain(tex, u, v, address_mode=REPEAT,
                                oob_value=0.0, mask=None):
    """Plain twin of the batched kernel: ``sample_bilinear_plain`` frame by
    frame, stacked."""
    return torch.stack([
        sample_bilinear_plain(tex[f], u[f], v[f], address_mode, oob_value,
                              None if mask is None else mask[f])
        for f in range(tex.shape[0])])


@functools.cache
def _lib():
    lib = _build.load_library()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mr_sample_bilinear.argtypes = [P, I, I, P, P, P, F, I, I, I, P, P]
    lib.mr_sample_bilinear.restype = I
    return lib


def _check_args(u, v, address_mode, mask):
    if u.shape != v.shape or (mask is not None and mask.shape != u.shape):
        raise ValueError("u, v and mask must have one shape")
    if address_mode not in (REPEAT, sampling.CLAMP):
        raise ValueError(f"unknown address mode {address_mode!r}")


def _launch(name, tex, u, v, address_mode, oob_value, mask, frames):
    device = tex.device
    _build.check("tex", tex, torch.float32, device)
    _build.check("u", u, torch.float32, device)
    _build.check("v", v, torch.float32, device)
    if mask is not None:
        _build.check("mask", mask, torch.bool, device)
    th, tw = tex.shape[-2:]
    if u.numel() >= 2 ** 31 or th * tw >= 2 ** 31:
        raise ValueError(f"{u.numel()} pixels, {th}x{tw} texels: the kernel "
                         "indexes them with 32-bit ints")
    out = torch.empty_like(u)
    err = _lib().mr_sample_bilinear(
        _build.ptr(tex), th, tw, _build.ptr(u), _build.ptr(v),
        _build.ptr(mask), float(oob_value), int(address_mode == REPEAT),
        frames, u.numel() // max(frames, 1), _build.ptr(out),
        _build.stream(device))
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def sample_bilinear(tex, u, v, address_mode=REPEAT, oob_value=0.0,
                    mask=None):
    """Bilinear sample of ``tex`` f32[TH, TW] at ``u, v`` f32[...] (kernel
    K7); ``mask`` bool[...] or None (every pixel). Returns f32 shaped like
    ``u``. CPU tensors go to the plain twin; CUDA tensors launch the kernel,
    and a failed launch raises."""
    if tex.dim() != 2:
        raise ValueError("tex: need a 2-D [H, W] texture")
    _check_args(u, v, address_mode, mask)
    if tex.device.type == "cpu":
        return sample_bilinear_plain(tex, u, v, address_mode, oob_value, mask)
    return _launch("sample_bilinear", tex, u, v, address_mode, oob_value,
                   mask, 1)


def sample_bilinear_batch(tex, u, v, address_mode=REPEAT, oob_value=0.0,
                          mask=None):
    """Frame f of ``u, v`` f32[F, H, W] sampled from its own texture
    ``tex[f]`` of f32[F, TH, TW] (kernel K8, one launch for all frames);
    ``mask`` bool[F, H, W] or None. Returns f32[F, H, W]. CPU tensors go to
    the plain twin; CUDA tensors launch the kernel, and a failed launch
    raises."""
    if tex.dim() != 3 or u.dim() != 3 or u.shape[0] != tex.shape[0]:
        raise ValueError("need textures [F, TH, TW] and grids [F, H, W]")
    _check_args(u, v, address_mode, mask)
    if tex.device.type == "cpu":
        return sample_bilinear_batch_plain(tex, u, v, address_mode,
                                           oob_value, mask)
    return _launch("sample_bilinear_batch", tex, u, v, address_mode,
                   oob_value, mask, tex.shape[0])
