"""``pass_device_ms`` (ms/frame, layer: passes + shading): the device time
of a frame's passes and shading: the union of the traced window's device
intervals (kernels, copies, sets) that the frame's prep did not put on the
card, per frame rendered. On the split path that is K1 (the shadow pass),
K3 (the G-buffer), the channel extraction and every kernel of the shading
chain, K7 and K9 among them; the name of no kernel is read. Moves
``frames_per_s``.

The prep's work is told apart by the profiler's correlation ids, not by
times: each device event carries the id of the runtime call that launched
it, a CUDA graph's kernels that of its ``cudaGraphLaunch``, and the
runtime calls that start inside the program's ``mr/prep`` spans
(``passes.pipeline.prepare_frame``: the prep graph's launch, its upload,
the geometry's copy) put the prep's work there. No host time is compared
with a device time.

Returns nothing without ``mr/prep`` spans, without device activity (a run
without a card), or where a device event in the window has no correlation
id (the trace could then not tell the prep's work from the passes')."""
from gpubench.harness import program_spans


def read(t):
    preps = program_spans.spans(t, lambda n: n == "mr/prep")
    if not t.device or not t.frames or not preps:
        return None
    inside = [(a, b, c) for (_, a, b, _), c
              in zip(t.device, t.device_correlation)
              if b > t.t0 and a < t.t1]
    if any(c is None for _, _, c in inside):
        return None
    prep = t.launched_in(preps)
    return t.busy_us([(a, b) for a, b, c in inside
                      if c not in prep]) * 1e-3 / t.frames
