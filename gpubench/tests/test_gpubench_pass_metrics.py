"""The split frame's readers on synthetic traces built as the harness's
own are: ``pass_device_ms`` tells the prep's device work from the passes'
by correlation ids (a graph's kernels carry their ``cudaGraphLaunch``'s),
``pass_roofline``'s least time is a function of ``work_of``'s counts
alone, whatever kernels the trace names, and ``gbuffer_kernel_ms`` reads
K3's two launches alone."""
import pytest

from conftest import BENCH, REPO

# A 1080p config-4 frame: 14 triangles, the 1024^2 map, one 256^2 mip
# chain of float32 rgba texels.
WORK = {"triangles": 14, "width": 1920, "height": 1080,
        "shadow_map_size": 1024, "texture_bytes": 87381 * 16,
        "light": "directional",
        "fragments": {"main": 8.0e6, "shadow": 3.0e5, "shaded": 1.6e6,
                      "normal_mapped": 1.0e5, "textured": 0,
                      "shadow_tested": 1.5e6}}
NAMES = {"k1": "(anonymous namespace)::raster_depth_kernel<1>(Args)",
         "k3": "(anonymous namespace)::raster_gbuffer_kernel<4, 4>(Bins)",
         "k7": "sample_bilinear_kernel(Args)",
         "k9": "sample_pyramid_kernel(Args)",
         "ew": "void at::native::vectorized_elementwise_kernel<4>(int)"}


def view(events, frames=2, work=WORK):
    from gpubench.harness import trace
    window = {"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0,
              "dur": 1000.0, "cat": "user_annotation"}
    return trace.TraceView([window] + events, frames, frames, work, {})


def ev(name, cat, ts, dur, corr=None):
    e = {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def reader(name):
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(name)


def split_events(names=NAMES, skew=0.0):
    """Two split frames. Each: a prep span holding the prep graph's
    launch and its upload; the graph's kernels and the upload on the
    device; then K1, K3, an elementwise kernel of the shading chain, K7,
    two K9 and a copy, launched after the prep. The device's clock runs
    ``skew`` us ahead of the host's: the prep's device work may start
    before its span opens on the host clock."""
    events = []
    corr = 0
    for t0 in (50.0, 500.0):
        def launch(name, at, cat="cuda_runtime"):
            nonlocal corr
            corr += 1
            events.append(ev(name, cat, t0 + at, 2.0, corr))
            return corr
        events.append(span("mr/frame", t0, 420.0))
        events.append(span("mr/prep", t0 + 5.0, 60.0))
        up = launch("cudaMemcpyAsync", 10.0)
        graph = launch("cudaGraphLaunch", 40.0)
        k1 = launch("cudaLaunchKernel", 80.0)
        k3 = launch("cudaLaunchKernelExC", 90.0)
        ew = launch("cudaLaunchKernel", 100.0)
        k7 = launch("cudaLaunchKernel", 110.0)
        k9a = launch("cudaLaunchKernel", 120.0)
        k9b = launch("cudaLaunchKernel", 130.0)
        cp = launch("cudaMemcpyAsync", 140.0)
        d = t0 + skew
        events += [
            ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", d + 12.0,
               8.0, up),
            ev("graph_kernel_a", "kernel", d + 42.0, 50.0, graph),
            ev("graph_kernel_b", "kernel", d + 92.0, 30.0, graph),
            ev(names["k1"], "kernel", d + 130.0, 20.0, k1),
            ev(names["k3"], "kernel", d + 150.0, 60.0, k3),
            ev(names["ew"], "kernel", d + 210.0, 30.0, ew),
            ev(names["k7"], "kernel", d + 240.0, 10.0, k7),
            ev(names["k9"], "kernel", d + 260.0, 20.0, k9a),
            ev(names["k9"], "kernel", d + 275.0, 20.0, k9b),
            ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", d + 300.0,
               10.0, cp)]
    return events


def split_trace(names=NAMES, skew=0.0):
    return view(split_events(names, skew))


# Each frame: K1 20, K3 60, elementwise 30, K7 10, the two K9 over
# 260..295 (35), the copy 10: 165 us, none of the prep's 88.
PASS_MS = 0.165


def test_gpubench_pass_device_ms_leaves_the_prep_out_by_correlation():
    assert reader("pass_device_ms").read(split_trace()) == \
        pytest.approx(PASS_MS)


def test_gpubench_pass_device_ms_reads_no_host_clock():
    # The device 30 us ahead of the host: the prep's upload and its
    # graph's first kernel start before the prep span opens on the host's
    # clock, and still count as the prep's.
    assert reader("pass_device_ms").read(split_trace(skew=30.0)) == \
        pytest.approx(PASS_MS)


def test_gpubench_pass_metrics_read_nothing_without_what_they_read():
    no_prep = view([e for e in split_events() if e["name"] != "mr/prep"])
    no_device = view([span("mr/prep", 10.0, 50.0),
                      ev("cudaGraphLaunch", "cuda_runtime", 20.0, 2.0, 1)])
    no_corr = view([span("mr/prep", 10.0, 50.0),
                    ev("cudaGraphLaunch", "cuda_runtime", 20.0, 2.0, 1),
                    ev("graph_kernel", "kernel", 30.0, 10.0),
                    ev(NAMES["k3"], "kernel", 100.0, 10.0)])
    for name in ("pass_device_ms", "pass_roofline"):
        for v in (no_prep, no_device, no_corr):
            assert reader(name).read(v) is None, name
    no_work = view(split_events(), work=dict(WORK, fragments=None))
    assert reader("pass_roofline").read(no_work) is None


def test_gpubench_pass_roofline_is_the_work_over_the_pass_time():
    spec = reader("pass_roofline")
    least, bound = spec.least_seconds(WORK)
    b = 96 * 14 + 16 * 1920 * 1080 + 8 * 1024 ** 2 + 87381 * 16
    ops = 17 * 8.3e6 + 60 * 1.6e6 + 229 * 1.0e5 + 60 * 1.5e6
    assert bound == "bytes"
    assert least == pytest.approx(max(b / 3.35e12, ops / 67e12))
    assert spec.read(split_trace()) == pytest.approx(
        100.0 * least * 1e3 / PASS_MS)
    # A point light's frame counts its per-pixel light vector.
    point = dict(WORK, light="point", width=1, height=1, shadow_map_size=0,
                 texture_bytes=0)
    least_pt, bound_pt = spec.least_seconds(point)
    assert bound_pt == "ops"
    assert least_pt == pytest.approx((ops + 13 * 1.6e6) / 67e12)


def test_gpubench_pass_roofline_reads_the_same_whatever_the_kernels():
    """The same device times under other kernel names (a later fused pass
    in place of K3, the chain, K7 and K9): the same reading, since the
    least time comes from ``work_of``'s counts alone."""
    fused = {k: "(anonymous namespace)::split_pass_fused_kernel<4>(Args)"
             for k in NAMES}
    a = reader("pass_roofline").read(split_trace())
    b = reader("pass_roofline").read(split_trace(names=fused))
    assert a == b and a > 0


def test_gpubench_pass_roofline_counts_the_reference_frames_work():
    """``work_of`` of config 4 at a small size: the counts the reference
    made for the frame, and the bytes of the normal map's mip chain."""
    import json
    import torch
    from gpubench.harness import check, core, inputs
    config = json.loads((BENCH / "configs" / "config4-1080p.json")
                        .read_text())
    config["render"].update(width=160, height=120, shadow_map_size=256)
    arrays = inputs.mesh_arrays(config)
    _, counts = check.reference_frame(config, arrays, {"displacement": 0.0},
                                      torch.device("cpu"), count=True)
    work = core.work_of(config, arrays, counts)
    assert work["triangles"] == 14 and work["light"] == "directional"
    assert work["texture_bytes"] == 16 * sum(4 ** k for k in range(9))
    c = work["fragments"]
    assert 0 < c["normal_mapped"] < c["shaded"] <= 160 * 120
    assert 0 < c["shadow_tested"] < c["shaded"]
    assert c["normal_mapped"] + c["shadow_tested"] <= c["shaded"]


def test_gpubench_gbuffer_kernel_ms_reads_both_launches_of_k3():
    """K3's tile launch and split launch, whatever its template arguments;
    not K3s, not K1, not the chain."""
    events = split_events()
    corr = 1000
    for t0 in (50.0, 500.0):
        # The split walk's second launch, overlapping the first by 10 us,
        # and K3s, which is not K3.
        corr += 2
        events += [
            ev("(anonymous namespace)::raster_gbuffer_kernel<1, 8>(Bins)",
               "kernel", t0 + 200.0, 30.0, corr),
            ev("(anonymous namespace)::raster_gbuffer_samples_kernel(Bins)",
               "kernel", t0 + 320.0, 40.0, corr + 1)]
    # Each frame: K3 over 150..210 and 200..230, the union 80 us.
    assert reader("gbuffer_kernel_ms").read(view(events)) == \
        pytest.approx(0.080)
    fused = {k: "(anonymous namespace)::render_fused_kernel<1, 4>(Args)"
             for k in NAMES}
    assert reader("gbuffer_kernel_ms").read(split_trace(names=fused)) \
        is None
    assert reader("gbuffer_kernel_ms").read(view(split_events(),
                                                 frames=0)) is None


# Config 4 at 160x120 from its default camera, nothing displaced: the
# reference's counts as they were before the reference learnt the color
# texture, which ``pass_roofline``'s least time is made of.
CONFIG4_SMALL = {"main": 68498, "shadow": 828, "shaded": 15173,
                 "normal_mapped": 2006, "shadow_tested": 13167}


def small_work(name, tmp_path, theta=None, **render):
    import json
    import torch
    from gpubench.harness import check, core, inputs
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    config["render"].update(render)
    for inst in config["instances"]:
        if "target_tris" in inst["mesh"]:
            inst["mesh"]["target_tris"] = 10000
    arrays = inputs.mesh_arrays(config, tmp_path)
    fi = {"displacement": 0.0} if theta is None else {"displacement": 0.0,
                                                      "theta": theta}
    _, counts = check.reference_frame(config, check.reference_arrays(arrays),
                                      fi, torch.device("cpu"), count=True)
    return core.work_of(config, arrays, counts)


def test_gpubench_config4_work_and_roofline_are_as_before(tmp_path):
    """Config 4 counts no textured pixel: its work, and so its
    ``pass_roofline``, reads what it read before the textured term."""
    spec = reader("pass_roofline")
    work = small_work("config4-1080p", tmp_path, width=160, height=120,
                      shadow_map_size=256)
    assert work["fragments"] == dict(CONFIG4_SMALL, textured=0)
    b = 96 * 14 + 16 * 160 * 120 + 8 * 256 ** 2 + 16 * sum(
        4 ** k for k in range(9))
    c = CONFIG4_SMALL
    ops = (17 * (c["main"] + c["shadow"]) + 60 * c["shaded"]
           + 229 * c["normal_mapped"] + 60 * c["shadow_tested"])
    assert spec.least_seconds(work) == (
        pytest.approx(max(b / 3.35e12, ops / 67e12)), "bytes")
    assert spec.least_seconds(dict(work, fragments=dict(
        c, textured=0)))[0] == spec.least_seconds(work)[0]


def test_gpubench_pass_roofline_counts_the_textured_pixels(tmp_path):
    """A config-3 frame: every shaded pixel takes the color lookup's 133
    operations on top of its Blinn-Phong under the point light, and the
    checkerboard's mip chain is read once."""
    spec = reader("pass_roofline")
    work = small_work("config3-obj-1080p", tmp_path, theta=3.4,
                      width=160, height=120)
    c = work["fragments"]
    assert work["light"] == "point" and work["shadow_map_size"] == 0
    assert work["texture_bytes"] == 16 * sum(4 ** k for k in range(10))
    assert 0 < c["textured"] == c["shaded"] < 160 * 120
    assert c["normal_mapped"] == c["shadow_tested"] == c["shadow"] == 0
    assert spec.OPS_COLOR_TEXTURE == 4 + 19 + 3 + 2 * 47 + 13 == 133
    ops = 17 * c["main"] + (60 + 13 + 133) * c["shaded"]
    untextured = dict(work, fragments=dict(c, textured=0),
                      width=1, height=1, triangles=0, texture_bytes=0)
    textured = dict(untextured, fragments=c)
    assert spec.least_seconds(textured) == (pytest.approx(ops / 67e12),
                                            "ops")
    assert spec.least_seconds(textured)[0] - spec.least_seconds(
        untextured)[0] == pytest.approx(133 * c["textured"] / 67e12)
