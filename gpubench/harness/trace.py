"""The traced run: spans from the benchmark's own wrappers, the profiler
over the window, and the reduction of its trace to what the per-layer
metrics read.

Spans: each metric file may list, in ``SPANS``, dotted names of the
program's functions (``package.module.function``); with ``--trace 1`` each
is replaced, on its module, by a wrapper that opens a
``torch.profiler.record_function`` span named ``gpubench:<dotted name>``.
A name that no longer resolves is skipped, and the metric that reads it
finds no span and prints null.

The trace: ``torch.profiler`` with CPU and CUDA activities over the whole
traced window, exported as a Chrome trace into the run's temporary
directory, read back and deleted. Device time is the union of the device
intervals (kernels, memcpy, memset), never a sum of durations: kernels
that overlap (the split tile walk's two launches) count once. Each device
event and each runtime call keeps the profiler's correlation id, which
ties the device's work to the host call that launched it (a CUDA graph's
kernels to its ``cudaGraphLaunch``) without comparing the host's clock
with the device's.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import re
import tempfile

SPAN_PREFIX = "gpubench:"
WINDOW_SPAN = SPAN_PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def install_spans(dotted_names):
    """Wrap each resolvable ``package.module.function`` in a span; returns
    the names wrapped."""
    import torch
    done = []
    for dotted in sorted(set(dotted_names)):
        mod_name, _, attr = dotted.rpartition(".")
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
        except (ImportError, AttributeError):
            continue
        if not callable(fn):
            continue

        def wrap(fn=fn, label=SPAN_PREFIX + dotted):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            return spanned
        setattr(mod, attr, wrap())
        done.append(dotted)
    return done


@contextlib.contextmanager
def profiled(device_is_cuda):
    """Profile the block; yields a list that holds the trace's events once
    the block has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_is_cuda:
        acts.append(ProfilerActivity.CUDA)
    events = []
    prof = profile(activities=acts)
    with prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield events
        if device_is_cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(json.load(f).get("traceEvents", []))
    finally:
        os.unlink(path)


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if end is not None:
        total += end - start
    return total


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _cut_args(name):
    """``name`` up to its argument list (the first ``(`` outside ``<>``)."""
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:k]
    return name


def short_name(name):
    """A device operation's name without ``void``, anonymous namespaces
    and its argument list, at most 160 characters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return _cut_args(name)[:160]


def base_name(name):
    """A kernel's own name: ``short_name`` without its namespaces, so
    ``(anonymous namespace)::render_fused_kernel<1, 4>`` reads
    ``render_fused_kernel<1, 4>``."""
    name = _cut_args(re.sub(r"^void\s+", "", name).replace(
        "(anonymous namespace)::", ""))
    depth, start = 0, 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and name.startswith("::", k):
            start = k + 2
    return name[start:]


def correlation(event):
    """The profiler's correlation id of a trace event, or None."""
    return (event.get("args") or {}).get("correlation")


class TraceView:
    """What a per-layer metric reads: the traced window's events (times in
    microseconds on the trace's clock), the frames and requests the window
    completed, the frame's work counts and the run's facts."""

    def __init__(self, events, frames, requests, work, facts):
        windows = [e for e in events if e.get("name") == WINDOW_SPAN
                   and e.get("ph") == "X"]
        if not windows:
            raise ValueError("the trace holds no window span")
        w = max(windows, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.frames, self.requests = frames, requests
        self.work, self.facts = work, facts
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(e["name"], float(e["ts"]), float(e["ts"]) +
                        float(e["dur"]), e.get("cat")) for e in x
                       if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["ts"]) +
                      float(e["dur"]), e.get("cat")) for e in x
                     if e.get("cat") in HOST_CATS]
        # Correlation ids (None where the trace gives none): of each device
        # event, in ``device``'s order, and of each runtime call as
        # (start, id).
        self.device_correlation = [correlation(e) for e in x
                                   if e.get("cat") in DEVICE_CATS]
        self.runtime_correlation = [
            (float(e["ts"]), correlation(e)) for e in x
            if e.get("cat") in ("cuda_runtime", "cuda_driver")]

    @property
    def window_us(self):
        return self.t1 - self.t0

    def clip(self, intervals):
        return [(max(a, self.t0), min(b, self.t1)) for a, b in intervals
                if b > self.t0 and a < self.t1]

    def kernels(self, prefixes=None):
        """(start, end) of the device kernels, those whose own name
        (``base_name``) starts with one of ``prefixes`` if given."""
        return [(a, b) for n, a, b, c in self.device if c == "kernel" and (
            prefixes is None or base_name(n).startswith(tuple(prefixes)))]

    def busy_us(self, intervals=None):
        """The union of device intervals inside the window."""
        if intervals is None:
            intervals = [(a, b) for _, a, b, _ in self.device]
        return union(self.clip(intervals))

    def spans(self, dotted):
        """(start, end) of the benchmark's span around ``dotted``."""
        label = SPAN_PREFIX + dotted
        return [(a, b) for n, a, b, c in self.host
                if c == "user_annotation" and n == label]

    def launched_in(self, intervals):
        """The correlation ids of the runtime calls that start inside one
        of ``intervals``: the device work those calls put on the card."""
        found = merged(intervals)
        starts = [a for a, _ in found]
        out = set()
        for a, c in self.runtime_correlation:
            k = bisect.bisect_right(starts, a) - 1
            if c is not None and k >= 0 and a <= found[k][1]:
                out.add(c)
        return out

    def runtime_calls(self, names):
        return [(a, b) for n, a, b, c in self.host
                if c in ("cuda_runtime", "cuda_driver") and n in names]

    def breakdown(self, top=10):
        """{"device_ops": [[kernel, seconds]], "idle_gaps": [[what the host
        was doing, seconds]]}, the ``top`` largest of each."""
        by_name = {}
        for n, a, b, c in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                k = short_name(n) if c == "kernel" else n
                by_name[k] = by_name.get(k, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged(self.clip([(a, b) for _, a, b, _ in self.device]))
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(s, n) for n, s, e, c in self.host
                     if s <= mid <= e and n != WINDOW_SPAN]
            name = max(inner)[1] if inner else "host outside any span"
            named.append([name, (b - a) * 1e-6])
        return {"device_ops": [[k, v * 1e-6] for k, v in ops],
                "idle_gaps": named}
