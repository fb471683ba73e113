"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary directory with every configuration cut to a size the CPU
renders in a moment, and a way to run one of its cells there."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "gpubench"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The CPU size of each configuration: the framebuffer, the shadow map and
# the dense mesh cut; everything else as the file says. The audio traffic's
# parts are cut to two buffers, so that the few requests of a CPU window
# hear every level and their frames differ.
TINY = {"width": 64, "height": 48, "shadow_map_size": 64}
TINY_TRIS = 2000
TINY_PART_BUFFERS = 2


def shrink(config):
    config = json.loads(json.dumps(config))
    render = config["render"]
    render.update({k: v for k, v in TINY.items()
                   if k != "shadow_map_size"
                   or render["shadow_map_size"] > 64})
    for inst in config["instances"]:
        if "target_tris" in inst["mesh"]:
            inst["mesh"]["target_tris"] = TINY_TRIS
    return config


def tiny_copy(tmp_path):
    """(BENCHMARK.json path, bench root) of a tiny copy of the benchmark
    under ``tmp_path``, with the parked cells (``parked.json``) back in its
    rows, so that their paths stay tested while they are out."""
    root = tmp_path / "gpubench"
    for kind in ("traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / kind, root / kind)
    for f in (root / "traffic").glob("*.json"):
        traffic = json.loads(f.read_text())
        if traffic["generator"] == "audio":
            traffic["part_buffers"] = TINY_PART_BUFFERS
            f.write_text(json.dumps(traffic))
    (root / "configs").mkdir(parents=True)
    for f in (BENCH / "configs").glob("*.json"):
        (root / "configs" / f.name).write_text(json.dumps(
            shrink(json.loads(f.read_text()))))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    parked = json.loads((BENCH / "parked.json").read_text())
    spec["configs"] += parked["configs"]
    spec["workloads"] += parked["workloads"]
    for m in spec["per_layer"]:
        if m["name"] in parked["per_layer"]:
            m["workloads"] += [w["name"] for w in parked["workloads"]]
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    return bench, root


@pytest.fixture
def tiny_bench(tmp_path):
    """(BENCHMARK.json path, bench root) of a tiny copy of the benchmark."""
    return tiny_copy(tmp_path)


def run_cell(bench, root, cell, seed=123456789012, seconds=0.3, traced=False,
             make_driver=None, min_requests=1):
    """One run of ``cell`` on the CPU: (result, compared lines)."""
    from gpubench.harness import core
    return core.run(bench, root, cell, seed, seconds, traced,
                    torch.device("cpu"), time.perf_counter(),
                    make_driver=make_driver, log=lambda *a: None,
                    min_requests=min_requests)
