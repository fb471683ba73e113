"""Profiling hooks (torch counterpart of
``metalrenderer_tpu.utils.profiling``): a device trace, wall timing with
device synchronization, and named spans."""
from __future__ import annotations

import contextlib
import pathlib
import tempfile
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace the host and, where a GPU is present, the device with
    torch.profiler; on exit the trace is written to ``log_dir``/trace.json
    (Chrome trace format, viewable in Perfetto). ``log_dir`` defaults to a
    new temporary directory. Yields the ``torch.profiler.profile``, whose
    ``trace_path`` names the file."""
    log_dir = pathlib.Path(log_dir or tempfile.mkdtemp(prefix="trace_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = log_dir / "trace.json"
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(prof.trace_path))


def _sync(out):
    """Wait for the device work behind ``out`` (a tensor, or a tuple, list
    or dict of them) when any of it is on a GPU."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())


def timed(fn, *args, iters=10, warmup=2, **kwargs):
    """Wall-time ``fn(*args, **kwargs)`` over ``iters`` calls after
    ``warmup`` calls, ending in a device synchronization when the output is
    on a GPU. Returns (seconds_per_call, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out


def annotate(name):
    """Named profiler span (shows up in the trace timeline)."""
    return torch.profiler.record_function(name)
