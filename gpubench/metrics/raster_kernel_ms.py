"""``raster_kernel_ms`` (ms/frame, layer: raster kernels): the union of
the device intervals of the port's raster kernels (``csrc/raster.cu``:
K1/K4 ``raster_depth_kernel``, K2/K6 ``render_fused_kernel``, both launches
of the split tile walk) in the traced window, per frame rendered. Moves
``frames_per_s``."""

PREFIXES = ("raster_depth_kernel", "render_fused_kernel")


def read(t):
    spans = t.kernels(PREFIXES)
    if not spans or not t.frames:
        return None
    return t.busy_us(spans) * 1e-3 / t.frames
