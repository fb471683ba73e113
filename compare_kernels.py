#!/usr/bin/env python3
"""Time the port's tile kernels under each ROOT, in turns, on one CUDA GPU:
K2 (render_fused), K6 (render_fused_batch), K3 (raster_gbuffer) and K5
(raster_gbuffer_batch).

    python3 compare_kernels.py ROOT [ROOT ...]   # e.g. a parent's checkout, .

Each root runs in a process of its own, its kernels built from its own
``metalrenderer_tpu_torch/csrc``, on the inputs of chip_smoke.py's phases 3,
6, 13 and 14: the flagship main pass (1920x1080 MSAA4, displacement 0.05),
phase 3's seeded 1920x1080 soup, the 8-frame flagship batch, BASELINE
config 4's main pass (1920x1080 MSAA4) and its 8-frame batch (the camera
orbiting by 0.01 rad a frame). Every time is taken two ways (this
checkout's chip_smoke.timings): back to back (the host may pace it), and
with the host ahead (``device_ms``: device time only). The roots run in the
order given, then in reverse (A B B A). Prints the card's name and power
limit, then one JSON line per root and turn; each kernel's output is
checked against its plain twin (``ok``: covered fractions equal and rgba
within 1e-5 for K2/K6, gout bit-equal for K3/K5).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
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


def fused_ok(k, p):
    import torch
    return torch.equal(k[1], p[1]) and float((k[0] - p[0]).abs().max()) <= 1e-5


def gout_ok(k, p):
    import torch
    gk = k[0] if isinstance(k, tuple) else k
    gp = p[0] if isinstance(p, tuple) else p
    return torch.equal(gk.view(torch.int32), gp.view(torch.int32))


def one(root):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    cs = smoke()
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
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
    scene4, cam4, light4, cfg4 = configs.config4_shadow_normal_map(W, H,
                                                                   device=dev)
    cfg4 = cfg4.replace(shadow_map_size=SHADOW)
    preps4 = [pipeline.prepare_frame(
        scene4, OrbitCamera(radius=5.0, theta=2.5 + 0.01 * i, phi=1.2,
                            aspect=W / H), light4, cfg4, device=dev)
        for i in range(BATCH)]
    mb4 = pipeline.prepare_frame(scene4, cam4, light4, cfg4,
                                 device=dev).main_bins
    mb48 = raster_cuda.stack_bins([p.main_bins for p in preps4])
    fused = (raster_cuda.render_fused, raster_cuda.render_fused_plain)
    gbuf = (raster_cuda.raster_gbuffer, raster_cuda.raster_gbuffer_plain)
    cases = {
        "k2_flagship": (*fused, fused_ok, (prep.main_bins, prep.uniforms,
                                           smap), 200),
        "k2_soup": (*fused, fused_ok, (soup, prep.uniforms, smap), 100),
        "k6_flagship8": (raster_cuda.render_fused_batch,
                         raster_cuda.render_fused_batch_plain, fused_ok,
                         (mb8, uni8, smaps8), 50),
        "k3_config4": (*gbuf, gout_ok, (mb4,), 200),
        "k3_soup": (*gbuf, gout_ok, (soup,), 100),
        "k5_config4x8": (raster_cuda.raster_gbuffer_batch,
                         raster_cuda.raster_gbuffer_batch_plain, gout_ok,
                         (mb48,), 50)}
    log = (_build.library_path().parent / "build.log").read_text()
    out = {"root": str(root),
           "ptxas": {k: v for k, v in cs.ptxas_summary(log).items()
                     if k.startswith(("render_fused", "raster_gbuffer_kernel"))}}
    for name, (kernel, plain, check, args, reps) in cases.items():
        full = args + (W, H, samples)
        ok = check(kernel(*full), plain(*full))
        torch.cuda.synchronize()
        ms, dev_ms = cs.timings(lambda: kernel(*full), reps)
        out[name] = {"ok": ok, "ms": round(ms, 5), "device_ms": round(dev_ms, 5)}
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
