"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result.

The cell's row of ``BENCHMARK.json`` names its configuration and traffic;
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json`` hold them, and each per-layer metric is
``metrics/<name>.py``. Adding a cell, a configuration, a traffic mix or a
metric is adding those files and rows: nothing here names one.

The window is a closed loop with one request in flight: a request is one
call into the cell's entry, its latency runs from that call to a
``torch.cuda.synchronize()`` after its frames, and the next request starts
when it has ended. Requests start until ``seconds`` have passed; the
window ends when the last of them does.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import check, entries, inputs, trace as trace_mod

BANNED_MODULES = ("jax", "jaxlib", "flax", "metalrenderer_tpu")


def read_json(path):
    with open(path) as f:
        return json.load(f)


class Catalog:
    """The benchmark's named files under ``root`` and its rows in
    ``bench``."""

    def __init__(self, bench_path, root):
        self.bench = read_json(bench_path)
        self.root = pathlib.Path(root)

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def file(self, kind, name):
        return read_json(self.root / kind / f"{name}.json")

    def metrics(self, section, cell):
        """The rows of ``section`` that the cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or cell in m["workloads"]]

    def metric_reader(self, name):
        path = self.root / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def banned_modules():
    """Modules loaded in this process whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED_MODULES))


def device_facts(device):
    """The card's name and its power limit (nvidia-smi), or the CPU's."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        facts["power_limit"] = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return facts


def work_of(config, mesh_arrays, counts):
    """The frame's own sizes, which the rooflines read: triangles in the
    scene, the framebuffer, the shadow map (0 without a shadow pass), the
    bytes of the textures' mip chains, the light's kind and the
    reference's mean work a frame (``reference.frame.render``'s counts, or
    None)."""
    from ..reference import scene as ref_scene
    instances = ref_scene.build(config, mesh_arrays)[0]
    r = ref_scene.RenderConfig(**config["render"])
    shadow = (any(i.cast_shadow for i in instances)
              and any(i.kind == ref_scene.BLINN_PHONG_SHADOW
                      for i in instances))
    return {"triangles": sum(i.mesh.num_triangles for i in instances),
            "width": r.width, "height": r.height,
            "shadow_map_size": r.shadow_map_size if shadow else 0,
            "texture_bytes": sum(
                level.numel() * level.element_size()
                for mips in ref_scene.texture_chains(mesh_arrays)
                for level in mips),
            "light": config["light"]["kind"],
            "fragments": counts}


def end_to_end(latencies_s, frames, window_s, setup_s):
    """The end-to-end metrics of a window: {name: (value, unit)}. The rate
    is every frame completed over the whole window; the tail is the 95th
    percentile (linear interpolation) of every request's latency."""
    lat_ms = np.asarray(latencies_s, dtype=np.float64) * 1e3
    return {"frames_per_s": (frames / window_s, "frames/s"),
            "latency_p95_ms": (float(np.percentile(lat_ms, 95)), "ms"),
            "setup_s": (setup_s, "s")}


def run(bench_path, root, cell_name, seed, seconds, traced, device,
        t_process_start, make_driver=None, log=print, min_requests=1):
    """Run the cell; returns (result dict, the compared lines). ``device``:
    a torch.device; ``make_driver``: replaces ``entries.make`` (the control
    and the fault tests put their drivers in the program's place);
    ``min_requests``: the window runs at least so many requests. The
    configuration's OBJ meshes are written to a temporary directory (under
    ``TMPDIR``), removed when the run ends."""
    with tempfile.TemporaryDirectory(prefix="gpubench-") as obj_dir:
        return _run(bench_path, root, cell_name, seed, seconds, traced,
                    device, t_process_start, make_driver, log, min_requests,
                    obj_dir)


def _run(bench_path, root, cell_name, seed, seconds, traced, device,
         t_process_start, make_driver, log, min_requests, obj_dir):
    import torch
    cat = Catalog(bench_path, root)
    cell = cat.cell(cell_name)
    config = cat.file("configs", cell["config"])
    traffic = cat.file("traffic", cell["traffic"])
    wl = cat.file("workloads", cell_name)
    e2e = cat.metrics("end_to_end", cell_name)
    per_layer = cat.metrics("per_layer", cell_name) if traced else []
    readers = {m["name"]: cat.metric_reader(m["name"]) for m in per_layer}
    if traced:
        trace_mod.install_spans([s for r in readers.values()
                                 for s in getattr(r, "SPANS", ())])
    is_cuda = device.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(device)

    mesh_arrays = inputs.mesh_arrays(config, obj_dir)
    driver = (make_driver or entries.make)(
        wl["entry"], config, traffic, wl, seed, device, mesh_arrays)
    driver.warmup()
    per = int(traffic["frames_per_request"])
    if is_cuda:
        # The window keeps the sampled requests' frames for the check: let
        # the caching allocator hold their blocks now, so that keeping
        # them calls no cudaMalloc inside the window.
        shape = (per, config["render"]["height"], config["render"]["width"],
                 4)
        spare = [torch.empty(shape, device=device)
                 for _ in range(int(wl["check_requests"]) + 1)]
        del spare
    sync()
    window = min(seconds, wl.get("trace_seconds", seconds)) if traced \
        else seconds
    reservoir = check.Reservoir(wl["check_requests"], seed)
    latencies, track_parts = [], []
    setup_s = time.perf_counter() - t_process_start
    with (trace_mod.profiled(is_cuda) if traced
          else contextlib.nullcontext([])) as events:
        t_start = time.perf_counter()
        t_end = t_start
        i = 0
        while i < min_requests or time.perf_counter() - t_start < window:
            t0 = time.perf_counter()
            frames, track = driver.request(i)
            sync()
            t_end = time.perf_counter()
            latencies.append(t_end - t0)
            reservoir.offer(i, frames)
            if track is not None:
                track_parts.append(track)
            del frames, track
            i += 1
    window_s = t_end - t_start
    n_req = len(latencies)
    n_frames = n_req * per
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    facts = device_facts(device)

    driver_close = getattr(driver, "close", None)
    if driver_close:
        driver_close()
    track_np = entries.stack_track(track_parts) if track_parts else None
    track_parts = None
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    numbers, failed_req, counts = check.compare(
        config, mesh_arrays, traffic, driver, reservoir.kept, track_np,
        wl["limits"], device, want_counts=traced)
    reservoir.kept.clear()
    del driver

    e2e_values = end_to_end(latencies, n_frames, window_s, setup_s)
    log(f"gpubench: cell {cell_name} seed {seed} device "
        f"{facts['kind']} power_limit {facts['power_limit']} requests "
        f"{n_req} frames {n_frames} window_s {window_s} latency_median_ms "
        f"{statistics.median(latencies) * 1e3} latency_p95_ms "
        f"{e2e_values['latency_p95_ms'][0]} traced {int(traced)}")
    device_out = {"platform": facts["platform"], "kind": facts["kind"],
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": n_req,
              "failed": len(failed_req), "metrics": {},
              "device": device_out}
    if traced:
        view = trace_mod.TraceView(events, n_frames, n_req,
                                   work_of(config, mesh_arrays, counts),
                                   facts)
        device_out["busy_s"] = view.busy_us() * 1e-6
        device_out["window_s"] = view.window_us * 1e-6
        for m in per_layer:
            v = readers[m["name"]].read(view)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        result["breakdown"] = view.breakdown()
    else:
        for m in e2e:
            v, _ = e2e_values[m["name"]]
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    limits = wl["limits"]
    within = all(numbers[k] <= limits[k] for k in numbers)
    result["correct"] = bool(within and not failed_req)
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in sorted(numbers)}
    lines = [f"compared {k} {numbers[k]!r} limit {limits[k]!r}"
             for k in sorted(numbers)]
    return result, lines
