"""The sphere cells' readers on synthetic traces built as the harness's own
are: the fused kernel's time over both launches of the split walk, its
roofline on ``raster_roofline``'s count, the prep's device time between
its span and the fused kernel, and the entry's host time."""
import pytest

from conftest import BENCH, REPO

NEW = ["fused_kernel_ms", "fused_roofline", "prep_device_ms",
       "entry_host_ms"]
TILE = "(anonymous namespace)::render_fused_kernel<1, false>(Bins, Samples)"
SPLIT = "(anonymous namespace)::render_fused_kernel<1, true>(Bins, Samples)"
# The dense sphere at 3840x2160, no shadow pass: bound by its bytes.
WORK = {"triangles": 1_000_000, "width": 3840, "height": 2160,
        "shadow_map_size": 0,
        "fragments": {"main": 4_000_000.0, "shadow": 0.0}}


def view(events, frames=2, work=WORK):
    from gpubench.harness import trace
    window = {"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0,
              "dur": 1000.0, "cat": "user_annotation"}
    return trace.TraceView([window] + events, frames, frames, work, {})


def ev(name, cat, ts, dur):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def reader(name):
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(name)


def frames_trace():
    """Two frames, each: an entry span holding a prep span, the prep's
    device work (a graph's kernels, a copy and a set; one kernel
    overlapping another), then the split launch and the tile launch of the
    fused kernel, overlapping; device work before the first prep and
    after the last fused kernel belongs to no prep."""
    events = [ev("kernel_before", "kernel", 0.0, 20.0)]
    for t0 in (100.0, 500.0):
        events += [
            span("mr/frame", t0, 300.0),
            span("mr/prep", t0 + 10.0, 60.0),
            ev("cudaGraphLaunch", "cuda_runtime", t0 + 60.0, 5.0),
            ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t0 + 20.0,
               10.0),
            ev("graph_kernel_a", "kernel", t0 + 40.0, 50.0),
            ev("graph_kernel_b", "kernel", t0 + 80.0, 30.0),
            ev("Memset (Device)", "gpu_memset", t0 + 115.0, 5.0),
            ev(SPLIT, "kernel", t0 + 150.0, 100.0),
            ev(TILE, "kernel", t0 + 160.0, 40.0),
            # After the fused kernel: the stats' copy, no prep's.
            ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t0 + 260.0,
               10.0)]
    return view(events)


def test_gpubench_fused_kernel_ms_counts_both_launches_once():
    # Each frame: the split launch 150..250 holds the tile launch 160..200.
    assert reader("fused_kernel_ms").read(frames_trace()) == \
        pytest.approx(0.100)
    t = view([ev(SPLIT, "kernel", 100.0, 50.0),
              ev(TILE, "kernel", 140.0, 60.0),
              ev("raster_depth_kernel<1>", "kernel", 300.0, 500.0)])
    # 100..200 over two frames; the depth kernel is not the fused kernel.
    assert reader("fused_kernel_ms").read(t) == pytest.approx(0.050)


def test_gpubench_prep_device_ms_reads_between_prep_and_fused_kernel():
    # Each frame: the copy 20..30, the kernels 40..110, the set 115..120:
    # 85 us. The first prep's window opens with its span: the kernel
    # before it counts for no prep; the second's opens where the first
    # frame's fused kernel ends (350), so the first frame's copy after it
    # (10 us) counts there; the second frame's copy, after the last fused
    # kernel, counts for no prep.
    assert reader("prep_device_ms").read(frames_trace()) == \
        pytest.approx((85.0 + 95.0) * 1e-3 / 2)


def test_gpubench_prep_device_ms_reads_the_device_clock():
    # The device's times run 40 us ahead of the host's: the second frame's
    # prep work (its copy at 520) starts "before" its span opens at 550 on
    # the host clock, and still counts, as it follows the first frame's
    # fused kernel (ending at 350).
    t = view([span("mr/prep", 110.0, 50.0),
              ev("graph_a", "kernel", 120.0, 30.0),
              ev(TILE, "kernel", 200.0, 150.0),
              span("mr/prep", 550.0, 50.0),
              ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 520.0,
                 10.0),
              ev("graph_b", "kernel", 540.0, 30.0),
              ev(TILE, "kernel", 600.0, 150.0)])
    assert reader("prep_device_ms").read(t) == pytest.approx(
        (30.0 + 10.0 + 30.0) * 1e-3 / 2)


def test_gpubench_prep_device_ms_over_a_batch_counts_once():
    # Two preps, then one fused launch for both frames: each prep's work
    # lies in the first prep's window and in its own; counted once.
    t = view([span("mr/batch", 50.0, 700.0),
              span("mr/prep", 100.0, 50.0),
              ev("graph_a", "kernel", 110.0, 40.0),
              span("mr/prep", 200.0, 50.0),
              ev("graph_b", "kernel", 210.0, 40.0),
              ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 260.0,
                 20.0),
              ev("render_fused_kernel<1, false>", "kernel", 400.0, 100.0)])
    assert reader("prep_device_ms").read(t) == pytest.approx(0.050)


def test_gpubench_fused_roofline_reads_raster_roofline_count():
    from gpubench.harness import core
    cat = core.Catalog(REPO / "BENCHMARK.json", BENCH)
    spec = cat.metric_reader("raster_roofline")
    least, bound = spec.least_seconds(WORK)
    assert bound == "bytes"
    t = frames_trace()
    want = 100.0 * least * 1e3 / reader("fused_kernel_ms").read(t)
    assert reader("fused_roofline").read(t) == pytest.approx(want)
    # Without a shadow pass the fused kernel is every raster kernel: the
    # two rooflines agree.
    assert reader("raster_roofline").read(t) == pytest.approx(want)


def test_gpubench_entry_host_ms_reads_the_entry_spans_once():
    # Two mr/frame spans of 300 us, over two frames.
    assert reader("entry_host_ms").read(frames_trace()) == \
        pytest.approx(0.300)
    # A batch whose frames fell back to render_frame: the frames' spans lie
    # inside the batch's and count once.
    t = view([span("mr/batch", 100.0, 400.0),
              span("mr/frame", 150.0, 100.0),
              span("mr/frame", 300.0, 100.0),
              ev("kernel", "kernel", 200.0, 10.0)])
    assert reader("entry_host_ms").read(t) == pytest.approx(0.200)


@pytest.mark.parametrize("name", NEW)
def test_gpubench_sphere_readers_read_nothing_without_spans_or_kernels(
        name):
    """No fused kernel (a window without one), no program span (a program
    without ``mr/frame``, ``mr/batch``, ``mr/prep``) or no device activity
    (a run without a card): each reader returns None where it has nothing
    to read."""
    no_kernel = view([span("mr/frame", 100.0, 300.0),
                      span("mr/prep", 110.0, 50.0),
                      ev("graph", "kernel", 120.0, 30.0)])
    no_span = view([ev("graph", "kernel", 120.0, 30.0),
                    ev(TILE, "kernel", 200.0, 30.0)])
    no_device = view([span("mr/frame", 100.0, 300.0),
                      span("mr/prep", 110.0, 50.0)])
    found = {"fused_kernel_ms": (no_span,), "fused_roofline": (no_span,),
             "prep_device_ms": (), "entry_host_ms": (no_kernel,)}[name]
    for t in (no_kernel, no_span, no_device):
        got = reader(name).read(t)
        if t in found:
            assert got is not None
        else:
            assert got is None, (name, got)
    no_counts = view([ev(TILE, "kernel", 200.0, 30.0)],
                     work=dict(WORK, fragments=None))
    if name == "fused_roofline":
        assert reader(name).read(no_counts) is None
