"""K9: trilinear mip-chain sampling, a CUDA kernel with its plain twin.

``sample_pyramid`` replaces ``metalrenderer_tpu/raster/mip_pallas.py``
``sample_pyramid_tiled`` (-> ``_sample_padded``): three channels of a mip
chain sampled at f32 ``u, v, lod`` grids, REPEAT or CLAMP, the LOD clipped
to ``[0, L-1]``, levels ``floor(lod)`` and ``min(floor(lod)+1, L-1)``
blended by ``frac(lod)``, pixels outside ``mask`` 0: exactly
``sampling.sample_trilinear``. The grids may have any shape: [H, W],
[F, H, W] frames or [S, H, W] sample planes, one launch over the flattened
planes (the JAX kernel takes such a stack whole, too).

The Pallas kernel walks per-tile visit lists of DMA windows and, where a
tile's footprint does not fit them (three or more uv islands, or more
visits than slots), samples a coarser level. None of that exists here: the
packed chain (``build_pyramid``, every level RGBA, row-major, one after the
other) stays in L2 and each thread reads its taps directly, so every pixel
is sampled exactly. The CUDA source is ``csrc/sample.cu``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, sampling
from .sampling import REPEAT

MAX_LEVELS = 16     # csrc/sample.cu kMaxLevels: a 32768^2 base level

# Launch count of the kernel; the wrapper adds one per launch.
LAUNCHES = {"sample_pyramid": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """A mip chain packed for the kernel."""

    texels: torch.Tensor   # f32[N, 4]: every level's RGBA texels, level 0 first
    sizes: tuple           # ((h, w), ...) per level
    offsets: tuple         # first texel of each level in ``texels``


def build_pyramid(mips) -> Pyramid:
    """Pack a mip chain (f32[h, w, C >= 3] levels, level 0 first) into one
    RGBA texel buffer on the levels' device. A 3-channel level gets a zero
    fourth channel; channels past the fourth are dropped."""
    if not 1 <= len(mips) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} mip levels supported")
    parts, sizes, offsets, n = [], [], [], 0
    for m in mips:
        if m.dim() != 3 or m.shape[-1] < 3:
            raise ValueError("mip levels must be [h, w, C>=3]")
        m = m.to(torch.float32)
        if m.shape[-1] == 3:
            m = torch.cat([m, torch.zeros_like(m[..., :1])], dim=-1)
        h, w = int(m.shape[0]), int(m.shape[1])
        parts.append(m[..., :4].reshape(h * w, 4))
        sizes.append((h, w))
        offsets.append(n)
        n += h * w
    return Pyramid(texels=torch.cat(parts).contiguous(), sizes=tuple(sizes),
                   offsets=tuple(offsets))


def _bilinear_levels(texels, base, h, w, u, v, address_mode):
    """sampling.sample_bilinear at a per-pixel level (``base`` first texel,
    ``h, w`` int64 sizes): RGB, f32[..., 3]."""
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    if address_mode == REPEAT:
        xa, xb = torch.remainder(xi, w), torch.remainder(xi + 1, w)
        ya, yb = torch.remainder(yi, h), torch.remainder(yi + 1, h)
    else:
        xa = torch.minimum(torch.clamp_min(xi, 0), w - 1)
        xb = torch.minimum(torch.clamp_min(xi + 1, 0), w - 1)
        ya = torch.minimum(torch.clamp_min(yi, 0), h - 1)
        yb = torch.minimum(torch.clamp_min(yi + 1, 0), h - 1)
    rgb = texels[:, :3]
    t00 = rgb[base + ya * w + xa]
    t10 = rgb[base + ya * w + xb]
    t01 = rgb[base + yb * w + xa]
    t11 = rgb[base + yb * w + xb]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_pyramid_plain(pyr: Pyramid, u, v, lod, mask=None,
                         address_mode=REPEAT):
    """Plain PyTorch twin of the kernel (same inputs, same arithmetic)."""
    dev = u.device
    n = len(pyr.sizes)
    off = torch.tensor(pyr.offsets, dtype=torch.int64, device=dev)
    hs = torch.tensor([s[0] for s in pyr.sizes], dtype=torch.int64,
                      device=dev)
    ws = torch.tensor([s[1] for s in pyr.sizes], dtype=torch.int64,
                      device=dev)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    lo = torch.floor(lod)
    frac = (lod - lo)[..., None]
    li = torch.clamp(lo.to(torch.int64), 0, n - 1)
    hi = torch.clamp_max(li + 1, n - 1)
    if mask is not None:
        zero = torch.zeros_like(u)
        u, v = torch.where(mask, u, zero), torch.where(mask, v, zero)
    a = _bilinear_levels(pyr.texels, off[li], hs[li], ws[li], u, v,
                         address_mode)
    b = _bilinear_levels(pyr.texels, off[hi], hs[hi], ws[hi], u, v,
                         address_mode)
    out = a * (1.0 - frac) + b * frac
    planes = tuple(out[..., c] for c in range(3))
    if mask is None:
        return planes
    return tuple(torch.where(mask, p, torch.zeros_like(p)) for p in planes)


@functools.cache
def _lib():
    lib = _build.load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mr_sample_pyramid.argtypes = [P, I, P, P, P, P, P, P, P, I, I, P, P]
    lib.mr_sample_pyramid.restype = I
    return lib


def sample_pyramid(pyr: Pyramid, u, v, lod, mask=None, address_mode=REPEAT):
    """Trilinear sample of a packed mip chain at ``u, v, lod`` f32[...]
    (kernel K9); ``mask`` bool[...] or None (every pixel). Returns three
    f32 planes shaped like ``u``. CPU tensors go to the plain twin; CUDA
    tensors launch the kernel, and a failed launch raises."""
    if u.shape != v.shape or lod.shape != u.shape or (
            mask is not None and mask.shape != u.shape):
        raise ValueError("u, v, lod and mask must have one shape")
    if address_mode not in (REPEAT, sampling.CLAMP):
        raise ValueError(f"unknown address mode {address_mode!r}")
    device = pyr.texels.device
    if device.type == "cpu":
        return sample_pyramid_plain(pyr, u, v, lod, mask, address_mode)
    _build.check("texels", pyr.texels, torch.float32, device)
    for name, t in (("u", u), ("v", v), ("lod", lod)):
        _build.check(name, t, torch.float32, device)
    if mask is not None:
        _build.check("mask", mask, torch.bool, device)
    n_levels = len(pyr.sizes)
    ints = ctypes.c_int * n_levels
    out = torch.empty((3,) + tuple(u.shape), dtype=torch.float32,
                      device=device)
    err = _lib().mr_sample_pyramid(
        _build.ptr(pyr.texels), n_levels, ints(*pyr.offsets),
        ints(*(s[0] for s in pyr.sizes)), ints(*(s[1] for s in pyr.sizes)),
        _build.ptr(u), _build.ptr(v), _build.ptr(lod), _build.ptr(mask),
        int(address_mode == REPEAT), u.numel(), _build.ptr(out),
        _build.stream(device))
    _build.raise_on(err, "sample_pyramid")
    LAUNCHES["sample_pyramid"] += 1
    return out[0], out[1], out[2]
