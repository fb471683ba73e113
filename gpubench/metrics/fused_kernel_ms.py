"""``fused_kernel_ms`` (ms/frame, layer: raster kernels): the union of the
device intervals of the fused main-pass kernel (``csrc/raster.cu``:
K2/K6 ``render_fused_kernel``, the tile launch and the split launch of
the split tile walk both) in the traced window, per frame rendered. The
kernel whose fragment stage interpolates the attributes. Moves
``frames_per_s``."""

PREFIXES = ("render_fused_kernel",)


def read(t):
    spans = t.kernels(PREFIXES)
    if not spans or not t.frames:
        return None
    return t.busy_us(spans) * 1e-3 / t.frames
