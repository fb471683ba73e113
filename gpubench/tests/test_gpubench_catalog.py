"""The benchmark is driven by data: every cell, configuration, traffic mix
and per-layer metric that ``BENCHMARK.json`` names is a file of its own,
found by name, and a cell made of new files alone runs."""
import json
import re

import pytest

from conftest import BENCH, REPO, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_gpubench_keys_and_names_follow_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    assert SPEC["command"][1] == "gpubench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for section in ("end_to_end", "per_layer"):
        for m in SPEC[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in SPEC[s]]
    assert len(names) == len(set(names))
    texts = ([c[k] for c in SPEC["configs"] for k in ("source", "why")]
             + [json.loads((REPO / c["file"]).read_text())[k]
                for c in SPEC["configs"] for k in ("source", "path")]
             + [w["why"] for w in SPEC["workloads"]]
             + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"])
    for text in texts:
        assert 1 <= len(text) <= 200 and text.isprintable(), text
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in SPEC["workloads"]:
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_gpubench_every_cell_is_found_by_name(cell):
    row = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert wl["entry"] in ("stream_audio_reactive", "render_frame",
                           "render_batch")
    assert (BENCH / "configs" / f"{row['config']}.json").is_file()
    assert (BENCH / "traffic" / f"{row['traffic']}.json").is_file()
    assert set(wl["limits"]) >= {"frame_mae", "tile_mae"}


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_gpubench_every_config_is_its_file(config):
    assert config["file"] == f"gpubench/configs/{config['name']}.json"
    data = json.loads((REPO / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_gpubench_every_metric_has_a_reader(metric):
    from gpubench.harness import core
    reader = core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(
        metric)
    assert callable(reader.read)


def test_gpubench_a_cell_made_of_new_files_runs(tiny_bench):
    """A configuration, a traffic mix and a cell added as files and rows,
    with no code edited, run to a correct result."""
    bench, root = tiny_bench
    cfg = json.loads((root / "configs" / "sphere1m-4k.json").read_text())
    cfg["camera"] = {"radius": 2.5, "theta": 1.0, "phi": 1.0}
    (root / "configs" / "sphere-side.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "animated-batch2.json")
                         .read_text())
    traffic["frames_per_request"] = 3
    (root / "traffic" / "animated-batch3.json").write_text(
        json.dumps(traffic))
    (root / "workloads" / "sphere-side-batch3.json").write_text(json.dumps(
        {"entry": "render_batch", "warmup_requests": 1, "check_requests": 1,
         "trace_seconds": 1,
         "limits": {"frame_mae": 1e-4, "tile_mae": 1e-3}}))
    spec = json.loads(bench.read_text())
    sphere = next(c for c in spec["configs"] if c["name"] == "sphere1m-4k")
    spec["configs"].append(dict(sphere, name="sphere-side"))
    spec["workloads"].append({"name": "sphere-side-batch3",
                              "config": "sphere-side",
                              "traffic": "animated-batch3", "chips": 1,
                              "why": "a test cell"})
    bench.write_text(json.dumps(spec))
    result, _ = run_cell(bench, root, "sphere-side-batch3")
    assert result["correct"] is True
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "latency_p95_ms",
                                      "setup_s"}
