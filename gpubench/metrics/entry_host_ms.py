"""``entry_host_ms`` (ms/frame, layer: entry): the host wall time inside
the program's entry spans, ``mr/frame`` (``passes.pipeline.render_frame``)
and ``mr/batch`` (``render_batch``), their union in the traced window, per
frame rendered: the prep, the launches and whatever the entry waits on.
Moves ``frames_per_s``.

Returns nothing without those spans (a program without them) or without
device activity (a run without a card)."""
from gpubench.harness import program_spans
from gpubench.harness.trace import merged

ENTRY_SPANS = ("mr/frame", "mr/batch")


def read(t):
    found = merged(program_spans.spans(t, lambda n: n in ENTRY_SPANS))
    if not t.device or not t.frames or not found:
        return None
    return sum(b - a for a, b in found) * 1e-3 / t.frames
