"""The end-to-end metrics take every request, and the roofline counts the
frame's own work, not how the program bins it."""
import json

import pytest

from conftest import BENCH, REPO, shrink


def test_gpubench_p95_is_over_all_requests():
    from gpubench.harness import core
    steady = [0.010] * 20
    stalled = steady[:-1] + [1.0]
    a = core.end_to_end(steady, 20, 1.0, 5.0)["latency_p95_ms"][0]
    b = core.end_to_end(stalled, 20, 1.0, 5.0)["latency_p95_ms"][0]
    assert a == pytest.approx(10.0)
    assert b > 50.0        # one stall in twenty moves the tail
    rate = core.end_to_end(stalled, 40, 2.0, 5.0)["frames_per_s"][0]
    assert rate == pytest.approx(20.0)


@pytest.mark.parametrize("change", [
    {"tile_w": 64, "tile_h": 16}, {"span_cap": 2}, {"span_cap": 16},
    {"tile_w": 32, "tile_h": 32, "span_cap": 4, "big_capacity": 64}])
@pytest.mark.parametrize("name", ["audioapp-1080p", "sphere1m-4k"])
def test_gpubench_roofline_counts_ignore_the_binning(name, change):
    """The same frame binned on other tiles or with another span cap has
    the same least time: the counts come from the frame alone."""
    import torch
    from gpubench.harness import check, core, inputs
    spec = importlib_metric()
    config = shrink(json.loads((BENCH / "configs" / f"{name}.json")
                               .read_text()))
    other = json.loads(json.dumps(config))
    other["render"].update(change)
    arrays = inputs.mesh_arrays(config)
    fi = {"displacement": 0.03}
    if name.startswith("audioapp"):
        fi.update(light_color=(0.9, 0.5, 0.2), light_intensity=0.9)
    works = []
    for c in (config, other):
        _, counts = check.reference_frame(c, arrays, fi, torch.device("cpu"),
                                          count=True)
        works.append(core.work_of(c, arrays, counts))
    assert works[0]["fragments"]["main"] > 0
    assert works[0] == works[1]
    assert spec.least_seconds(works[0]) == spec.least_seconds(works[1])


def importlib_metric():
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(
        "raster_roofline")


def test_gpubench_roofline_bytes_of_the_flagship_frame():
    """1080p: 20 bytes a pixel out, the 1024^2 map, 26 triangles in."""
    spec = importlib_metric()
    work = {"triangles": 26, "width": 1920, "height": 1080,
            "shadow_map_size": 1024,
            "fragments": {"main": 8e6, "shadow": 1e5}}
    least, bound = spec.least_seconds(work)
    want = (96 * 26 + 20 * 1920 * 1080 + 4 * 1024 ** 2) / 3.35e12
    assert bound == "bytes" and least == pytest.approx(want)
