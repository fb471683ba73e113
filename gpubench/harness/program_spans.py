"""The program's own spans in a traced window, as the per-stage metrics
read them.

The port opens ``torch.profiler.record_function`` spans named ``mr/...``
on its frame path (``metalrenderer_tpu_torch.utils.profiling.annotate``);
they land in the same trace as the kernels, copies and runtime calls, as
``user_annotation`` host events. A runtime call belongs to a span when it
starts inside the span's interval: the frame path runs on one host
thread, so no thread id is needed. Every value is per frame rendered.

Each reader returns None where the trace holds no device activity (a run
without a card: its host times are not the card's run) or none of the
spans it reads (a program without them)."""
from __future__ import annotations

import bisect
from importlib import util as _util
from pathlib import Path as _Path

from .trace import merged

PREFIX = "mr/"

_spec = _util.spec_from_file_location(
    "gpubench_metric_launches_per_frame_for_spans",
    _Path(__file__).parents[1] / "metrics" / "launches_per_frame.py")
_launches = _util.module_from_spec(_spec)
_spec.loader.exec_module(_launches)
LAUNCH_CALLS = _launches.LAUNCH_CALLS


def spans(t, match):
    """(start, end) of the program's spans whose name satisfies ``match``,
    clipped to the window."""
    return t.clip([(a, b) for n, a, b, c in t.host
                   if c == "user_annotation" and n.startswith(PREFIX)
                   and match(n)])


def ms_per_frame(t, match):
    """Host wall time inside the matching spans, ms per frame."""
    found = spans(t, match)
    if not t.device or not t.frames or not found:
        return None
    return sum(b - a for a, b in found) * 1e-3 / t.frames


def calls_per_frame(t, call_names, match):
    """Runtime calls named ``call_names`` that start inside the union of
    the matching spans, per frame; None unless the window launched a
    kernel (a trace of the card's runtime)."""
    found = merged(spans(t, match))
    if (not t.device or not t.frames or not found
            or not t.clip(t.runtime_calls(LAUNCH_CALLS))):
        return None
    starts = [a for a, _ in found]
    n = 0
    for a, _ in t.clip(t.runtime_calls(call_names)):
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and a <= found[k][1]:
            n += 1
    return n / t.frames


def overlap(xs, ys):
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(t):
    """The window's device-idle intervals: the window minus the union of
    its kernel, memcpy and memset intervals, as ``TraceView.breakdown``
    computes them."""
    gaps, prev = [], t.t0
    for a, b in merged(t.clip([(a, b) for _, a, b, _ in t.device])):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t.t1 > prev:
        gaps.append((prev, t.t1))
    return gaps
