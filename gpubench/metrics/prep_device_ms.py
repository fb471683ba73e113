"""``prep_device_ms`` (ms/frame, layer: host prep): the device time of the
frame's prep (on the card one CUDA graph replay a frame: bake, clipping,
setup, binning, the attribute table) in the traced window, per frame
rendered: the union of the device intervals (kernels, copies, sets)
between the fused kernels (``render_fused_kernel``) around each of the
program's ``mr/prep`` spans (``passes.pipeline.prepare_frame``): from the
end of the last fused kernel that starts before the span opens (or the
span's opening, before the first) to the start of the first fused kernel
after it. Moves ``frames_per_s``.

The window's ends are the device's own times: the profiler's host and
device clocks may sit milliseconds apart in a run, and a span's opening
on the host clock then cuts into its own prep's device work. What else
runs there (the previous frame's ops after its fused kernel: a reduction
of its covered fraction) counts too, microseconds a frame.

Returns nothing without ``mr/prep`` spans, without a fused kernel after
one, or without device activity (a run without a card)."""
import bisect

from gpubench.harness import program_spans
from gpubench.harness.trace import merged

FUSED = ("render_fused_kernel",)


def read(t):
    preps = sorted(a for a, _ in program_spans.spans(
        t, lambda n: n == "mr/prep"))
    fused = sorted(t.kernels(FUSED))
    if not t.device or not t.frames or not preps or not fused:
        return None
    starts = [a for a, _ in fused]
    windows = set()
    for p in preps:
        k = bisect.bisect_right(starts, p)
        if k == len(fused):
            continue
        begin = max(b for _, b in fused[:k]) if k else p
        windows.add((begin, starts[k]))
    if not windows:
        return None
    windows = merged(windows)
    los = [lo for lo, _ in windows]
    inside = []
    for _, a, b, _ in t.device:
        k = bisect.bisect_right(los, a) - 1
        if k >= 0 and a < windows[k][1]:
            inside.append((a, b))
    return t.busy_us(inside) * 1e-3 / t.frames
