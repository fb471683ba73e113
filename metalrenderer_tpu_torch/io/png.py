"""Minimal dependency-free PNG read/write (numpy + zlib).

The swapchain/present path of the reference (CAMetalLayer, mtl_engine.mm:
794-808) is replaced by pure-functional framebuffer outputs; this module is
the "present" equivalent: framebuffer array -> PNG bytes/file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6,
               row_filter: str = "sub") -> bytes:
    """image: uint8 [H,W] (gray), [H,W,3] (RGB) or [H,W,4] (RGBA).

    ``row_filter="sub"`` (default) delta-codes each row against the
    pixel to its left before deflate — on rendered framebuffers
    (smooth shading gradients) this is ~6x faster to compress AND
    ~10-50x smaller than filter-none at the same zlib level, which is
    what makes PNG-per-frame serving (turntables, streaming audio
    frames, interactive sessions) keep up with the renderer. Both the
    filter and its inverse are exact mod-256 arithmetic (lossless for
    any content).
    """
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("encode_png expects uint8; use to_srgb_u8 first")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    if row_filter == "sub":
        filt = image.astype(np.int16)
        filt[:, 1:, :] -= image[:, :-1, :]
        rows = (filt & 0xFF).astype(np.uint8).reshape(h, w * c)
        ftype = 1
    elif row_filter == "none":
        rows = image.reshape(h, w * c)
        ftype = 0
    else:
        raise ValueError(f"unknown row_filter {row_filter!r}")
    raw = np.concatenate(
        [np.full((h, 1), ftype, np.uint8), rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder: 8-bit gray/RGB/RGBA, no interlace, no palette."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if bit_depth != 8:
        raise ValueError(f"unsupported bit depth {bit_depth}")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub: running sum along the row, mod 256
            px = line.reshape(w, channels).astype(np.int64)
            line = (np.cumsum(px, axis=0) & 0xFF).astype(
                np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                left = int(line[i - channels]) if i >= channels else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                cc = int(prev[i - channels]) if i >= channels else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown filter {ftype}")
        out[row] = line
        prev = line
    return out.reshape(h, w, channels)


def to_u8(image) -> np.ndarray:
    """Linear f32 [0,1] framebuffer -> uint8 (no gamma; the reference
    renders to a plain BGRA8Unorm drawable without sRGB conversion)."""
    arr = np.asarray(image, np.float32)
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)


def write_png(path, image, drop_alpha=True, level=6, row_filter="sub"):
    """Write a framebuffer (f32 [H,W,3|4] in [0,1] or uint8) to a PNG."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = to_u8(arr)
    if drop_alpha and arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]
    with open(path, "wb") as f:
        f.write(encode_png(arr, level=level, row_filter=row_filter))


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
