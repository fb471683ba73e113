"""The per-stage readers: the program's ``mr/`` spans split the prep and
the track, runtime calls count where they start, and the idle time no
span holds is read against the device's idle time, on synthetic traces
built as the harness's own are."""
import pytest

from conftest import BENCH, REPO

LAUNCH = "cudaLaunchKernel"
NEW = ["scene_ms", "sync_wait_ms", "prep_launches_per_frame",
       "track_launches_per_frame", "host_copies_per_frame",
       "idle_unspanned_pct"]


def view(events, frames=2):
    from gpubench.harness import trace
    window = {"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0,
              "dur": 1000.0, "cat": "user_annotation"}
    return trace.TraceView([window] + events, frames, frames, {}, {})


def ev(name, cat, ts, dur):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def reader(name):
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(name)


def frame_trace():
    """Two frames of one chunk: a track with two host reads, a read of
    its parameters, a scene a frame, a prep a frame with its five stages,
    and launches and copies inside and outside the spans; the kernels
    leave the device idle over 100..900 us."""
    events = [
        span("mr/track", 5.0, 40.0),
        span("mr/track/sync", 10.0, 5.0),
        span("mr/track/sync", 30.0, 5.0),
        span("mr/params/sync", 46.0, 5.0),
        ev(LAUNCH, "cuda_runtime", 7.0, 1.0),
        ev(LAUNCH, "cuda_runtime", 20.0, 1.0),
        ev("cudaMemcpyAsync", "cuda_runtime", 11.0, 1.0),
        ev("cudaMemcpyAsync", "cuda_runtime", 47.0, 1.0),
        # A launch that starts before the track and ends inside it.
        ev(LAUNCH, "cuda_runtime", 2.0, 4.0),
        ev("kernel_track", "kernel", 0.0, 100.0),
        ev("kernel_frames", "kernel", 900.0, 100.0)]
    for k, t0 in enumerate((100.0, 450.0)):
        events += [
            span("mr/scene", t0, 20.0),
            ev("cudaMemcpyAsync", "cuda_runtime", t0 + 5.0, 1.0),
            span("mr/prep", t0 + 30.0, 300.0),
            span("mr/prep/bake", t0 + 40.0, 10.0),
            span("mr/prep/shadow", t0 + 60.0, 30.0),
            span("mr/prep/shadow_bin", t0 + 100.0, 40.0),
            span("mr/prep/main", t0 + 150.0, 50.0),
            span("mr/prep/main_bin", t0 + 210.0, 100.0),
            ev(LAUNCH, "cuda_runtime", t0 + 41.0, 1.0),
            ev(LAUNCH, "cuda_runtime", t0 + 151.0, 1.0),
            ev("cudaLaunchKernelExC", "cuda_runtime", t0 + 211.0, 1.0),
            ev("cudaMemcpy", "cuda_runtime", t0 + 320.0, 1.0),
            # Between the prep's stages: the prep's, no stage's.
            ev(LAUNCH, "cuda_runtime", t0 + 145.0, 1.0),
            # After the prep, in no span.
            ev(LAUNCH, "cuda_runtime", t0 + 335.0, 1.0),
            ev("cudaMemcpyAsync", "cuda_runtime", t0 + 336.0, 1.0)]
    return view(events)


@pytest.mark.parametrize("name", ["scene_ms"])
def test_gpubench_stage_ms_reads_its_own_span(name):
    # Two frames, one scene span of 20 us a frame.
    assert reader(name).read(frame_trace()) == pytest.approx(20e-3)


def test_gpubench_sync_wait_ms_reads_every_sync_span():
    # Two track reads and one parameter read, 5 us each, over two frames.
    assert reader("sync_wait_ms").read(frame_trace()) == pytest.approx(
        15e-3 / 2)


def test_gpubench_launches_count_where_they_start():
    t = frame_trace()
    # Four launches start inside each prep (bake, main, main_bin, and one
    # between stages); the one after it and the one before the track do
    # not count.
    assert reader("prep_launches_per_frame").read(t) == pytest.approx(4.0)
    # Two launches start inside the one track, over two frames.
    assert reader("track_launches_per_frame").read(t) == pytest.approx(1.0)
    assert reader("launches_per_frame").read(t) == pytest.approx(
        (2 * 5 + 3) / 2)


def test_gpubench_host_copies_count_each_copy_once():
    # Inside spans: the track's (nested in a sync span too) and the
    # parameters' read, then each frame's scene copy and prep copy; the
    # copy after each prep is in no span.
    assert reader("host_copies_per_frame").read(frame_trace()) == \
        pytest.approx((2 + 2 * 2) / 2)


def test_gpubench_idle_unspanned_on_a_gap_half_covered_by_a_span():
    # The device is idle over 100..900 (800 us); a prep span covers
    # 100..500 of it, the host is in no span over 500..900.
    t = view([ev("kernel_a", "kernel", 0.0, 100.0),
              ev("kernel_b", "kernel", 900.0, 100.0),
              span("mr/prep", 50.0, 450.0),
              ev("aten::mul", "cpu_op", 600.0, 10.0)])
    assert reader("idle_unspanned_pct").read(t) == pytest.approx(50.0)
    assert reader("device_idle_pct").read(t) == pytest.approx(80.0)


def test_gpubench_idle_unspanned_counts_nested_spans_once():
    t = frame_trace()
    # Idle 100..900 us; covered: two scenes (20) and two preps (300), the
    # stages inside the preps adding nothing.
    assert reader("idle_unspanned_pct").read(t) == pytest.approx(
        100.0 * (800.0 - 2 * 20.0 - 2 * 300.0) / 800.0)


@pytest.mark.parametrize("name", NEW)
def test_gpubench_a_program_without_spans_reads_nothing(name):
    """The parent's program opens no ``mr/`` span: every new reader
    returns None on its trace, and the benchmark's own wrapper spans are
    not the program's."""
    t = view([span("gpubench:metalrenderer_tpu_torch.passes.pipeline."
                   "prepare_frame", 100.0, 300.0),
              span("prepare/sync", 500.0, 10.0),
              ev(LAUNCH, "cuda_runtime", 120.0, 1.0),
              ev("cudaMemcpyAsync", "cuda_runtime", 130.0, 1.0),
              ev("kernel_a", "kernel", 0.0, 100.0)])
    assert reader(name).read(t) is None


@pytest.mark.parametrize("name", NEW)
def test_gpubench_a_run_without_the_card_reads_nothing(name):
    """The CPU's traced run has the spans but no device activity: no
    per-stage number is written for it."""
    t = view([span(s, 100.0 + 10 * k, 5.0) for k, s in enumerate(
        ["mr/scene", "mr/prep", "mr/prep/bake", "mr/prep/shadow",
         "mr/prep/shadow_bin", "mr/prep/main", "mr/prep/main_bin",
         "mr/track", "mr/track/sync"])])
    assert reader(name).read(t) is None
