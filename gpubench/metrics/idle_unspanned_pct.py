"""``idle_unspanned_pct`` (%, layer: device): the share of the device's
idle time (the traced window minus the union of its kernel, memcpy and
memset intervals) in which the host was inside none of the program's
``mr/`` spans: idle time that no stage of the frame path owns (the
harness's loop, a collection pause, code outside the spans). Moves
``frames_per_s``."""
from gpubench.harness import program_spans
from gpubench.harness.trace import merged


def read(t):
    found = merged(program_spans.spans(t, lambda n: True))
    gaps = program_spans.idle_gaps(t)
    idle = sum(b - a for a, b in gaps)
    if not t.device or not found or idle <= 0:
        return None
    return 100.0 * (idle - program_spans.overlap(gaps, found)) / idle
