"""Profiling hooks (torch counterpart of
``metalrenderer_tpu.utils.profiling``): a device trace and named spans.

The frame path opens ``annotate`` spans named ``mr/...`` (the entries
``passes.pipeline.render_frame`` and ``render_batch``, the stages of
``prepare_frame``, the audio track, the per-frame scene,
the host reads of the track's parameters and the kernel launches). They
are ``torch.profiler.record_function`` ranges in the same trace as the
kernels, copies and runtime calls, and cost nothing but a flag test when
no profiler is recording."""
from __future__ import annotations

import contextlib
import pathlib
import tempfile

import torch
import torch.autograd.profiler as _autograd_profiler

# The one context manager every span returns while no profiler records.
_NO_SPAN = contextlib.nullcontext()


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


def annotate(name):
    """Named profiler span (shows up in the trace timeline) while a
    profiler records; otherwise a shared no-op context manager. ``name``
    is a fixed string, so that every call of one span reads alike."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
