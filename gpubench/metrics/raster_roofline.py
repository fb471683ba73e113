"""``raster_roofline`` (%, layer: raster kernels): the least time the
H100 needs for a frame's raster work over the raster kernels' time
(``raster_kernel_ms``'s union of intervals), as a percentage. Moves
``frames_per_s``.

The least time is the larger of bytes / 3.35 TB/s and operations /
67 TFLOP/s (NVIDIA's H100 SXM data sheet: HBM3 bandwidth, fp32 outside the
tensor cores, at a 700 W power limit), counted from the frame's own sizes
and never from the bins, the tile lists or the launch shape, so that a
later change to the binning or the kernels is read against the same work:

* bytes: each triangle's three vertices with their attributes, read once
  as the scene holds them (position 3, uv 2, normal 3 floats: 96 bytes a
  triangle), and the outputs written once: the rgba plane (16 bytes a
  pixel), the covered-fraction plane (4 bytes a pixel) and the shadow map
  (4 bytes a texel, where the frame has a shadow pass);
* operations: the fragments the frame needs, (triangle, sample) pairs
  with the sample inside the triangle, counted by the benchmark's
  reference for the main pass and the shadow pass (the mean over the
  frames it checked), times 17: three edge functions at 4 operations,
  the depth plane at 4 and the depth compare, the least a fragment's
  coverage and depth test take.

Returns nothing where the reference counted no fragments."""

from importlib import util as _util
from pathlib import Path as _Path

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
BYTES_PER_TRIANGLE = 3 * (3 + 2 + 3) * 4
BYTES_PER_PIXEL = 4 * 4 + 4
BYTES_PER_SHADOW_TEXEL = 4
OPS_PER_FRAGMENT = 3 * 4 + 4 + 1

_spec = _util.spec_from_file_location(
    "gpubench_metric_raster_kernel_ms_for_roofline",
    _Path(__file__).with_name("raster_kernel_ms.py"))
_kernel = _util.module_from_spec(_spec)
_spec.loader.exec_module(_kernel)


def least_seconds(work):
    """The least time of one frame's raster work (``work``: the harness's
    ``work_of``), and which bound sets it."""
    frags = work["fragments"]
    b = (BYTES_PER_TRIANGLE * work["triangles"]
         + BYTES_PER_PIXEL * work["width"] * work["height"]
         + BYTES_PER_SHADOW_TEXEL * work["shadow_map_size"] ** 2)
    ops = OPS_PER_FRAGMENT * (frags["main"] + frags["shadow"])
    by_bytes, by_ops = b / PEAK_BYTES_PER_S, ops / PEAK_FLOP_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "ops")


def read(t):
    if not t.work.get("fragments"):
        return None
    ms = _kernel.read(t)
    if not ms:
        return None
    least, _ = least_seconds(t.work)
    return 100.0 * least * 1e3 / ms
