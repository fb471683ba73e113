"""``fused_roofline`` (%, layer: raster kernels): the least time the H100
needs for a frame's raster work (``raster_roofline.least_seconds``, the
count the benchmark keeps: bytes over 3.35 TB/s or operations over
67 TFLOP/s, from the frame's own sizes) over the fused kernel's time
(``fused_kernel_ms``), as a percentage. In a frame without a shadow pass
the fused kernel is all of the raster work. Moves ``frames_per_s``.

Returns nothing where the reference counted no fragments or the window
ran no fused kernel."""

from importlib import util as _util
from pathlib import Path as _Path


def _load(name):
    spec = _util.spec_from_file_location(
        f"gpubench_metric_{name}_for_fused_roofline",
        _Path(__file__).with_name(f"{name}.py"))
    mod = _util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_roofline = _load("raster_roofline")
_kernel = _load("fused_kernel_ms")


def read(t):
    if not t.work.get("fragments"):
        return None
    ms = _kernel.read(t)
    if not ms:
        return None
    least, _ = _roofline.least_seconds(t.work)
    return 100.0 * least * 1e3 / ms
