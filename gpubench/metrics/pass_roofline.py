"""``pass_roofline`` (%, layer: passes + shading): the least time the H100
needs for a frame's passes and shading over their device time
(``pass_device_ms``), as a percentage. Moves ``frames_per_s``.

The least time is the larger of bytes / 3.35 TB/s and operations /
67 TFLOP/s (NVIDIA's H100 SXM data sheet: HBM3 bandwidth, fp32 outside the
tensor cores, at a 700 W power limit), counted from the frame's own sizes
(the harness's ``work_of``) and never from the kernels' names, launches or
intermediate planes, so that a later fused pass is read against the same
work as today's chain:

* bytes: each triangle's three vertices with their attributes, read once
  (96 bytes a triangle); the rgba plane written once (16 bytes a pixel);
  the shadow map written once and read once (8 bytes a texel, where the
  frame has a shadow pass); each texture's mip chain read once
  (``texture_bytes``, float32 rgba texels);
* operations: the fragments of both passes, counted by the benchmark's
  reference, times 17 (``raster_roofline``'s coverage and depth test),
  and the pixels the fragment stage shades, once each, counted by the
  reference too, times what ``reference/shading.py`` computes for them
  (an add, multiply, divide, square root, power, floor, logarithm,
  magnitude, min or max one operation, a clamp too; selects and compares
  none):

  - every shaded pixel, 60: Blinn-Phong under a directional light (the
    view vector and its norm 13, the half vector 13, the diffuse and
    specular dots with their clamps and power 13, the sum and the color
    8) and the coverage resolve's blend (13); a point light's per-pixel
    light vector adds 13;
  - a normal-mapped pixel, 229: the screen-space differences of position
    and uv (10), the tangent frame (29: the determinant, its magnitude and
    reciprocal, two vectors of 12), the three normalizations (30), one
    trilinear lookup (19 for its LOD; 3 to split the LOD; two bilinear
    rgba taps of 47, that is 11 for the coordinates and weights and 9 a
    channel; 13 for the level blend), unpacking and rotating the sample
    (21) and its normalization (10);
  - a shadow-tested pixel, 60: the light-space transform and remap (34),
    one bilinear tap of one channel (20), the bias and the factor (2) and
    the factor on four channels (4);
  - a textured pixel (its base color from a color texture, ``_sample_rgb``
    under ``_resolve_base_color_soa``), 133: the screen-space differences
    of uv (4), one trilinear lookup (19 for its LOD; 3 to split the LOD;
    two bilinear rgba taps of 47; 13 for the level blend); the select of
    the texel in place of the material's color none.

  A pixel that is normal-mapped and shadow-tested takes 60 + 229 + 60 =
  349; a textured pixel under a point light 60 + 13 + 133 = 206.

Returns nothing where the reference counted no work or where
``pass_device_ms`` reads nothing."""

from importlib import util as _util
from pathlib import Path as _Path

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
BYTES_PER_TRIANGLE = 3 * (3 + 2 + 3) * 4
BYTES_PER_PIXEL = 4 * 4
BYTES_PER_SHADOW_TEXEL = 2 * 4
OPS_PER_FRAGMENT = 3 * 4 + 4 + 1
OPS_PER_SHADED_PIXEL = 13 + 13 + 13 + 8 + 13
OPS_POINT_LIGHT = 13
BILINEAR_RGBA, BILINEAR_ONE = 11 + 9 * 4, 11 + 9
OPS_NORMAL_MAP = 10 + 29 + 30 + 19 + 3 + 2 * BILINEAR_RGBA + 13 + 21 + 10
OPS_SHADOW_TEST = 34 + BILINEAR_ONE + 2 + 4
OPS_COLOR_TEXTURE = 4 + 19 + 3 + 2 * BILINEAR_RGBA + 13

_spec = _util.spec_from_file_location(
    "gpubench_metric_pass_device_ms_for_roofline",
    _Path(__file__).with_name("pass_device_ms.py"))
_device = _util.module_from_spec(_spec)
_spec.loader.exec_module(_device)


def least_seconds(work):
    """The least time of one frame's passes and shading (``work``: the
    harness's ``work_of``), and which bound sets it."""
    c = work["fragments"]
    b = (BYTES_PER_TRIANGLE * work["triangles"]
         + BYTES_PER_PIXEL * work["width"] * work["height"]
         + BYTES_PER_SHADOW_TEXEL * work["shadow_map_size"] ** 2
         + work["texture_bytes"])
    per_pixel = OPS_PER_SHADED_PIXEL + (
        OPS_POINT_LIGHT if work["light"] == "point" else 0)
    ops = (OPS_PER_FRAGMENT * (c["main"] + c["shadow"])
           + per_pixel * c["shaded"] + OPS_NORMAL_MAP * c["normal_mapped"]
           + OPS_COLOR_TEXTURE * c["textured"]
           + OPS_SHADOW_TEST * c["shadow_tested"])
    by_bytes, by_ops = b / PEAK_BYTES_PER_S, ops / PEAK_FLOP_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "ops")


def read(t):
    if not t.work.get("fragments"):
        return None
    ms = _device.read(t)
    if not ms:
        return None
    least, _ = least_seconds(t.work)
    return 100.0 * least * 1e3 / ms
