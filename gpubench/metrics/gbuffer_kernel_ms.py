"""``gbuffer_kernel_ms`` (ms/frame, layer: raster kernels): the union of
the device intervals of the split path's G-buffer kernel (``csrc/raster.cu``:
K3/K5 ``raster_gbuffer_kernel``, the tile launch and the split launch of
the split tile walk both) in the traced window, per frame rendered. The
tile walk's own time on long tile lists, which ``pass_device_ms`` holds
together with the shading chain. Moves ``frames_per_s``."""

PREFIXES = ("raster_gbuffer_kernel",)


def read(t):
    spans = t.kernels(PREFIXES)
    if not spans or not t.frames:
        return None
    return t.busy_us(spans) * 1e-3 / t.frames
