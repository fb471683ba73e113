"""The trace's reduction: device time is the union of intervals, kernels
are matched by their own names, idle gaps are named by the host, and the
per-layer readers read what they should from a synthetic trace."""
import pytest

from conftest import BENCH, REPO


def view(events, frames=2, work=None):
    from gpubench.harness import trace
    window = {"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0,
              "dur": 1000.0, "cat": "user_annotation"}
    return trace.TraceView([window] + events, frames, frames, work or {}, {})


def ev(name, cat, ts, dur):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def reader(name):
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(name)


def test_gpubench_union_counts_overlapping_kernels_once():
    t = view([
        ev("void (anonymous namespace)::render_fused_kernel<1, true>(P)",
           "kernel", 100.0, 300.0),
        ev("void (anonymous namespace)::render_fused_kernel<1, false>(P)",
           "kernel", 200.0, 300.0),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 900.0, 50.0),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)",
           "kernel", 1200.0, 10.0)])
    assert t.busy_us() == pytest.approx(400.0 + 50.0)
    assert reader("device_idle_pct").read(t) == pytest.approx(55.0)
    # Two frames: (100..500) of raster kernels a window, 0.2 ms a frame.
    assert reader("raster_kernel_ms").read(t) == pytest.approx(0.2)


def test_gpubench_kernels_match_by_their_own_name():
    from gpubench.harness import trace
    assert trace.base_name(
        "void (anonymous namespace)::raster_depth_kernel<4>(Args)") == \
        "raster_depth_kernel<4>"
    assert trace.base_name("at::native::elementwise_kernel<128, 2, "
                           "at::native::F<float> >(int)") == \
        "elementwise_kernel<128, 2, at::native::F<float> >"
    t = view([ev("void other_render_fused_kernel<1>(P)", "kernel", 0, 10)])
    assert t.kernels(("render_fused_kernel",)) == []
    assert reader("raster_kernel_ms").read(t) is None


def test_gpubench_spans_and_launches_per_frame():
    t = view([
        ev("gpubench:metalrenderer_tpu_torch.passes.pipeline.prepare_frame",
           "user_annotation", 10.0, 300.0),
        ev("gpubench:metalrenderer_tpu_torch.passes.pipeline.prepare_frame",
           "user_annotation", 500.0, 100.0),
        ev("cudaLaunchKernel", "cuda_runtime", 20.0, 2.0),
        ev("cudaLaunchKernelExC", "cuda_runtime", 30.0, 2.0),
        ev("cudaMemcpyAsync", "cuda_runtime", 40.0, 2.0),
        ev("cudaLaunchKernel", "cuda_runtime", 2000.0, 2.0)], frames=2)
    assert reader("prep_ms").read(t) == pytest.approx(0.2)
    assert reader("launches_per_frame").read(t) == pytest.approx(1.0)
    assert reader("track_ms").read(t) is None


def test_gpubench_idle_gaps_are_named_by_the_innermost_host_op():
    t = view([
        ev("kernel_a", "kernel", 0.0, 100.0),
        ev("kernel_b", "kernel", 900.0, 100.0),
        ev("gpubench:x.prepare_frame", "user_annotation", 50.0, 800.0),
        ev("aten::nonzero", "cpu_op", 400.0, 200.0)])
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["aten::nonzero", pytest.approx(800e-6)]
    ops = dict(t.breakdown()["device_ops"])
    assert ops == {"kernel_a": pytest.approx(1e-4),
                   "kernel_b": pytest.approx(1e-4)}


def test_gpubench_a_span_on_a_name_that_is_gone_is_skipped():
    from gpubench.harness import trace
    assert trace.install_spans(["metalrenderer_tpu_torch.no_such.thing",
                                "metalrenderer_tpu_torch.passes.pipeline."
                                "no_such_function"]) == []
