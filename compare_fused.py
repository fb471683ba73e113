#!/usr/bin/env python3
"""Time K2 (render_fused) and K6 (render_fused_batch) of the port under
each ROOT, in turns, on one CUDA GPU:

    python3 compare_fused.py ROOT [ROOT ...]   # e.g. a parent's checkout, .

Each root runs in a process of its own, its kernels built from its own
``metalrenderer_tpu_torch/csrc``, on the inputs of chip_smoke.py's phases 3
and 13: the flagship main pass (1920x1080 MSAA4, displacement 0.05), phase
3's seeded 1920x1080 soup, and the 8-frame flagship batch. Every time is
taken two ways: back to back, as chip_smoke.cuda_ms (the host may pace
it), and with the host ahead (``device_ms``: device time only).
The roots run in the order given, then in reverse (A B B A). Prints the
card's name and power limit, then one JSON line per root and turn; each
kernel's output is checked against its plain twin (``ok``).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
W, H, SHADOW, BATCH = 1920, 1080, 1024, 8


def smoke():
    """This checkout's chip_smoke.py, whatever ``sys.path`` finds first."""
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, reps):
    """Mean device time of fn() over reps launches with the host ahead: the
    launches are queued behind a spinning kernel, so they run back to back
    whatever the wrapper's host cost (cuda_ms's back-to-back launches are
    paced by the host once a launch takes less than its wrapper)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3e6 * (host_ms + 5.0)))   # >= 1.5x at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise SystemExit("compare_fused: FAIL: the spin ended before "
                         "the launches were queued")
    end.synchronize()
    return start.elapsed_time(end) / reps


def one(root):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    cs = smoke()
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import _build, raster_cuda
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    if not Path(raster_cuda.__file__).is_relative_to(root):
        cs.fail(f"imported {raster_cuda.__file__}, not the port under {root}")
    dev = torch.device("cuda:0")
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW)
    lighting = Lighting(light=PointLight(), ambient_intensity=0.1,
                        shininess=32.0)
    scene = audio_app.build_scene(device=dev)
    samples = tuple(cfg.sample_positions)
    center = ((0.5, 0.5),)
    disps = [float(d) for d in np.linspace(0.0, 0.05, BATCH - 1)] + [5.0]
    cams = [cam] * (BATCH - 1) + [OrbitCamera(radius=5.0, theta=2.2, phi=1.2,
                                              aspect=W / H)]
    preps = [pipeline.prepare_frame(scene, c, lighting, cfg, displacement=d,
                                    shadow_target=(0.0, 0.0, -1.0),
                                    device=dev)
             for d, c in zip(disps, cams)]
    prep = pipeline.prepare_frame(scene, cam, lighting, cfg,
                                  displacement=0.05,
                                  shadow_target=(0.0, 0.0, -1.0), device=dev)
    smap = raster_cuda.raster_depth(prep.shadow_bins, SHADOW, SHADOW,
                                    center)[0][0]
    sb8 = raster_cuda.stack_bins([p.shadow_bins for p in preps])
    smaps8 = raster_cuda.raster_depth_batch(sb8, SHADOW, SHADOW,
                                            center)[0][:, 0]
    mb8 = raster_cuda.stack_bins([p.main_bins for p in preps])
    uni8 = torch.stack([p.uniforms for p in preps])
    soup = cs.fused_soup_bins(W, H, seed=3, device=dev)
    cases = {
        "k2_flagship": (raster_cuda.render_fused, raster_cuda.render_fused_plain,
                        (prep.main_bins, prep.uniforms, smap), 200),
        "k2_soup": (raster_cuda.render_fused, raster_cuda.render_fused_plain,
                    (soup, prep.uniforms, smap), 100),
        "k6_flagship8": (raster_cuda.render_fused_batch,
                         raster_cuda.render_fused_batch_plain,
                         (mb8, uni8, smaps8), 50)}
    log = (_build.library_path().parent / "build.log").read_text()
    out = {"root": str(root),
           "ptxas": {k: v for k, v in cs.ptxas_summary(log).items()
                     if "fused" in k}}
    for name, (kernel, plain, args, reps) in cases.items():
        full = args + (W, H, samples)
        rk, ck = kernel(*full)
        rp, cp = plain(*full)
        torch.cuda.synchronize()
        ok = torch.equal(ck, cp) and float((rk - rp).abs().max()) <= 1e-5
        del rk, ck, rp, cp
        out[name] = {"ok": ok,
                     "ms": round(cs.cuda_ms(lambda: kernel(*full), reps), 5),
                     "device_ms": round(device_ms(lambda: kernel(*full),
                                                     reps), 5)}
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        return one(Path(sys.argv[2]).resolve())
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for root in roots + roots[::-1]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
