#!/usr/bin/env python3
"""Time the port's raster kernels under each ROOT, in turns, on one CUDA
GPU: K1 (raster_depth), K4 (raster_depth_batch), K2 (render_fused), K6
(render_fused_batch), K3 (raster_gbuffer) and K5 (raster_gbuffer_batch).

    python3 compare_kernels.py ROOT [ROOT ...]   # e.g. a parent's checkout, .
    python3 compare_kernels.py --parts 1,2,4,8 ROOT [ROOT ...]

Each root runs in a process of its own, its kernels built from its own
``metalrenderer_tpu_torch/csrc``, on the inputs of chip_smoke.py's phases 2,
3, 6, 12, 13 and 14: the flagship shadow pass (1024^2, 64x128 tiles),
phase 2's 4,000-triangle soup and its crowded 1024^2 soup, the 8 shadow
passes of the flagship batch, the flagship main pass (1920x1080 MSAA4,
displacement 0.05), phase 3's seeded 1920x1080 soup, the 8-frame flagship
batch, BASELINE config 4's main pass (1920x1080 MSAA4) and its 8-frame
batch (the camera orbiting by 0.01 rad a frame). K1 and K4 are timed with
the winner plane and, where the root's ``raster_depth`` takes
``with_winner``, without it (``_nw``): the shadow path's form. With
``--parts``, a root whose ``raster_cuda`` splits K1/K4 tiles
(``_depth_parts``) is also timed at each of those fixed splits
(``_pN``). Every time is taken two ways (this checkout's
chip_smoke.timings): back to back (the host may pace it), and with the host
ahead (``device_ms``: device time only). The roots run in the order given,
then in reverse (A B B A). Prints the card's name and power limit, then one
JSON line per root and turn; each kernel's output is checked against its
plain twin (``ok``: depth bit-equal and winners equal for K1/K4, covered
fractions equal and rgba within 1e-5 for K2/K6, gout bit-equal for K3/K5).
"""
from __future__ import annotations

import hashlib
import importlib.util
import inspect
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


def digest(out):
    """The first 12 hex digits of a SHA-1 over an output's bytes (the
    tensors of a tuple in order, None skipped): equal across roots when
    their outputs are bit-equal."""
    import torch
    h = hashlib.sha1()
    for t in out if isinstance(out, tuple) else (out,):
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def depth_ok(k, p):
    import torch
    return (torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
            and (k[1] is None or torch.equal(k[1], p[1])))


def gout_ok(k, p):
    import torch
    gk = k[0] if isinstance(k, tuple) else k
    gp = p[0] if isinstance(p, tuple) else p
    return torch.equal(gk.view(torch.int32), gp.view(torch.int32))


def one(root, parts):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    cs = smoke()
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import _build, binning, raster_cuda
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
    soup4000 = cs.soup_setup(4000, SHADOW, seed=7, device=dev)
    soup4000 = binning.bin_triangles(soup4000,
                                     binning.build_tri_fields(soup4000),
                                     SHADOW, SHADOW, 128, 64)
    crowd = cs.fused_soup_bins(SHADOW, SHADOW, seed=3, device=dev, big=280,
                               tile_w=128, tile_h=64, big_extent=500.0)
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
    main = (W, H, samples)
    shadow = (SHADOW, SHADOW, center)
    depth = (raster_cuda.raster_depth, raster_cuda.raster_depth_plain,
             depth_ok)
    depth8 = (raster_cuda.raster_depth_batch,
              raster_cuda.raster_depth_batch_plain, depth_ok)
    cases = {
        "k1_flagship": (*depth, (prep.shadow_bins, *shadow), 200),
        "k1_soup4000": (*depth, (soup4000, *shadow), 200),
        "k1_crowd": (*depth, (crowd, *shadow), 100),
        "k4_flagship8": (*depth8, (sb8, *shadow), 100),
        "k2_flagship": (*fused, fused_ok, (prep.main_bins, prep.uniforms,
                                           smap, *main), 200),
        "k2_soup": (*fused, fused_ok, (soup, prep.uniforms, smap, *main),
                    100),
        "k6_flagship8": (raster_cuda.render_fused_batch,
                         raster_cuda.render_fused_batch_plain, fused_ok,
                         (mb8, uni8, smaps8, *main), 50),
        "k3_config4": (*gbuf, gout_ok, (mb4, *main), 200),
        "k3_soup": (*gbuf, gout_ok, (soup, *main), 100),
        "k5_config4x8": (raster_cuda.raster_gbuffer_batch,
                         raster_cuda.raster_gbuffer_batch_plain, gout_ok,
                         (mb48, *main), 50)}
    depth_forms = [("", {})]
    if "with_winner" in inspect.signature(raster_cuda.raster_depth).parameters:
        depth_forms.append(("_nw", {"with_winner": False}))
    auto_parts = getattr(raster_cuda, "_depth_parts", None)
    splits = [None] + (parts if auto_parts is not None else [])
    log = (_build.library_path().parent / "build.log").read_text()
    out = {"root": str(root),
           "ptxas": {k: v for k, v in cs.ptxas_summary(log).items()
                     if k.startswith(("render_fused", "raster_gbuffer_kernel",
                                      "raster_depth"))}}
    for name, (kernel, plain, check, args, reps) in cases.items():
        forms = [("", {}, None)]
        if name[:2] in ("k1", "k4"):
            forms = [(sfx + (f"_p{p}" if p else ""), kw, p)
                     for p in splits for sfx, kw in depth_forms]
        ref = plain(*args)
        for suffix, kw, p in forms:
            if auto_parts is not None:
                raster_cuda._depth_parts = (auto_parts if p is None else
                                            lambda bins, frames, p=p: p)
            res = kernel(*args, **kw)
            ok = check(res, ref)
            torch.cuda.synchronize()
            ms, dev_ms = cs.timings(lambda: kernel(*args, **kw), reps)
            out[name + suffix] = {"ok": ok, "ms": round(ms, 5),
                                  "device_ms": round(dev_ms, 5),
                                  "digest": digest(res)}
    if auto_parts is not None:
        raster_cuda._depth_parts = auto_parts
        out["parts"] = {"k1": auto_parts(prep.shadow_bins, 1),
                        "k4": auto_parts(sb8, BATCH)}
    print(json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    parts = []
    if args[:1] == ["--parts"]:
        parts = [int(p) for p in args[1].split(",")]
        args = args[2:]
    if args[:1] == ["--one"]:
        return one(Path(args[1]).resolve(), parts)
    roots = [Path(r).resolve() for r in args] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for root in roots + roots[::-1]:
        split = ["--parts", ",".join(map(str, parts))] if parts else []
        rc |= subprocess.run([sys.executable, __file__, *split, "--one",
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
