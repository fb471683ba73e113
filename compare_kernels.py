#!/usr/bin/env python3
"""Time the port's kernels under each ROOT, in turns, on one CUDA GPU: the
raster kernels K1 (raster_depth), K4 (raster_depth_batch), K2
(render_fused), K6 (render_fused_batch), K3 (raster_gbuffer) and K5
(raster_gbuffer_batch), and the samplers K7 (sample_bilinear), K8
(sample_bilinear_batch) and K9 (sample_pyramid).

    python3 compare_kernels.py ROOT [ROOT ...]   # e.g. a parent's checkout, .
    python3 compare_kernels.py --cases k7,k8,k9 ROOT [ROOT ...]
    python3 compare_kernels.py --parts 1,2,4,8 ROOT [ROOT ...]
    python3 compare_kernels.py --split 512:256,256:256 ROOT [ROOT ...]

Each root runs in a process of its own, its kernels built from its own
``metalrenderer_tpu_torch/csrc``. The raster kernels run on the inputs of
chip_smoke.py's phases 2, 3, 6, 12, 13 and 14: the flagship shadow pass
(1024^2, 64x128 tiles), phase 2's 4,000-triangle soup and its crowded
1024^2 soup, the 8 shadow passes of the flagship batch, the flagship main
pass (1920x1080 MSAA4, displacement 0.05), phase 3's seeded 1920x1080
soup, the 8-frame flagship batch, BASELINE config 4's main pass (1920x1080
MSAA4) and its 8-frame batch (the camera orbiting by 0.01 rad a frame);
and on BASELINE configs 2, 3 and 5 as phase 21 builds them from the root's
``engine/configs`` (``config_cases``: K2<4> on config 2, K3<1> on config
3, K2<1> on config 5 at 3840x2160 and K6<1> on its first two frames; K3
and K2 also with every tile list emptied but the longest, ``_longest``),
held by their digests across roots (their twins take seconds to minutes
a call; chip_smoke.py holds them against the twins). The samplers run on the lookups of phases 7, 8, 15 and 19: config 4's
shadow lookup (K7, ``k7_config4``) and normal-map lookup (K9), the shadow
lookups of its 8-frame batch against their 8 maps (K8), and the
supersampled flagship's shadow lookups: once per pixel at the first
covered sample (``k7_ss_px``) and over its [4, 1080, 1920] sample planes
against the one map (``k7_ss_planes4``). ``--cases`` keeps the cases whose
names start with one of its prefixes (inputs are built only for the
kernels kept). K1 and K4 are timed with the winner plane and, where the
root's ``raster_depth`` takes ``with_winner``, without it (``_nw``): the
shadow path's form. With ``--parts``, a root whose ``raster_cuda`` splits
K1/K4 tiles (``_depth_parts``) is also timed at each of those fixed
splits (``_pN``). With ``--split A:L,...``, a root whose ``raster_cuda``
splits long tiles of K2/K3/K5/K6 (``TILE_SPLIT_ABOVE``,
``TILE_SPLIT_SLICE``) is also timed with a tile split above A candidates
into slices of L (``_AaLl``). Every time is taken two ways (this checkout's
chip_smoke.timings): back to back (the host may pace it), and with the
host ahead (``device_ms``: device time only). The roots run in the order
given, then in reverse (A B B A). Prints the card's name and power limit,
then one JSON line per root and turn: each kernel's ptxas line, and per
case its times, its output's digest (equal across roots when their
outputs are bit-equal) and ``ok``, the check against its plain twin: depth
bit-equal and winners equal for K1/K4, covered fractions equal and rgba
within 1e-5 for K2/K6, gout bit-equal for K3/K5, the output bit-equal for
K7, K8 and K9.
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
RASTER = ("k1_flagship", "k1_soup4000", "k1_crowd", "k4_flagship8",
          "k2_flagship", "k2_soup", "k6_flagship8", "k3_config4", "k3_soup",
          "k5_config4x8")
CONFIGS = ("k2_config2", "k3_config3", "k3_config3_longest", "k2_config5",
           "k2_config5_longest", "k6_config5x2")
SAMPLERS = ("k7_config4", "k7_ss_px", "k7_ss_planes4", "k8_config4x8",
            "k9_config4")


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


def bits_ok(k, p):
    """Bit-equal outputs (a tensor or a tuple of tensors)."""
    import torch
    ks = k if isinstance(k, tuple) else (k,)
    ps = p if isinstance(p, tuple) else (p,)
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(ks, ps))


def gout_ok(k, p):
    import torch
    gk = k[0] if isinstance(k, tuple) else k
    gp = p[0] if isinstance(p, tuple) else p
    return torch.equal(gk.view(torch.int32), gp.view(torch.int32))


def raster_cases(cs, dev):
    """K1-K6 on the inputs of chip_smoke.py's phases 2, 3, 6, 12, 13, 14:
    {name: (kernel, plain, check, args, reps)}."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import binning, raster_cuda
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
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
    return {
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


def config_cases(cs, dev):
    """K2, K3 and K6 on BASELINE configs 2, 3 and 5, built by the root's
    engine/configs as chip_smoke.py's phase 21 builds them: K2<4> on config
    2 (1920x1080, no shadow map), K3<1> on config 3 (1920x1080, the 100k
    triangle OBJ asset), K2<1> on config 5 (3840x2160, displacement 0.05)
    and K6<1> on its first two frames; K3 and K2 also on the bins with
    every list emptied but the longest (``_longest``: one tile's walk).
    Their twins take seconds to minutes a call, so these cases are held by
    their digests across roots (and against their twins in chip_smoke.py):
    {name: (kernel, None, None, args, reps)}."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import raster_cuda
    s2 = configs.config2_multi_mesh(n_objects=cs.C2_OBJECTS, width=cs.CW,
                                    height=cs.CH, device=dev)
    p2 = pipeline.prepare_frame(*s2, device=dev)
    s3 = configs.config3_high_poly(target_tris=cs.C3_TRIS, width=cs.CW,
                                   height=cs.CH, device=dev)
    mb3 = pipeline.prepare_frame(*s3, device=dev).main_bins
    s5 = configs.config5_animated_high_poly(target_tris=cs.C5_TRIS,
                                            width=cs.C5_W, height=cs.C5_H,
                                            device=dev)
    disps = [float(d) for d in np.linspace(0.0, 0.05, cs.C5_FRAMES)]
    p5 = pipeline.prepare_frame(*s5, displacement=disps[-1], device=dev)
    preps = [pipeline.prepare_frame(*s5, displacement=d, device=dev)
             for d in disps[:2]]
    mb52 = raster_cuda.stack_bins([p.main_bins for p in preps])
    uni52 = torch.stack([p.uniforms for p in preps])
    one = tuple(s3[3].sample_positions)
    fused, gbuf = raster_cuda.render_fused, raster_cuda.raster_gbuffer
    c3, c5 = (cs.CW, cs.CH, one), (cs.C5_W, cs.C5_H, one)
    return {
        "k2_config2": (fused, None, None, (
            p2.main_bins, p2.uniforms, None, cs.CW, cs.CH,
            tuple(s2[3].sample_positions)), 100),
        "k3_config3": (gbuf, None, None, (mb3, *c3), 50),
        "k3_config3_longest": (gbuf, None, None, (
            cs.longest_list_bins(mb3)[0], *c3), 50),
        "k2_config5": (fused, None, None, (p5.main_bins, p5.uniforms, None,
                                           *c5), 20),
        "k2_config5_longest": (fused, None, None, (
            cs.longest_list_bins(p5.main_bins)[0], p5.uniforms, None, *c5),
            20),
        "k6_config5x2": (raster_cuda.render_fused_batch, None, None,
                         (mb52, uni52, None, *c5), 20)}


def sampler_cases(dev):
    """K7, K8 and K9 on the lookups of chip_smoke.py's phases 7, 8, 15 and
    19: config 4's shadow lookup and normal-map lookup, the shadow lookups
    of its 8-frame batch, and the supersampled flagship's per-pixel shadow
    lookup and its [4, H, W] sample planes against the one map:
    {name: (kernel, plain, check, args, reps)}."""
    import torch
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import (mip_cuda, raster_cuda,
                                                sample_cuda, sampling, shade)
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    from metalrenderer_tpu_torch.scene.materials import BLINN_PHONG_SHADOW
    center = ((0.5, 0.5),)
    k7 = (sample_cuda.sample_bilinear, sample_cuda.sample_bilinear_plain,
          bits_ok)

    def lookup(ch, light_m, first_covered=False):
        w = (ch["wx"], ch["wy"], ch["wz"])
        needs = (ch["kind"] == BLINN_PHONG_SHADOW) & ch["covered"]
        if first_covered:
            w, _ = shade._first_covered(w, ch["covered"])
            needs = torch.any(needs, dim=0)
        u, v, _, inb = shade._shadow_coords(w, light_m)
        return u, v, sampling.REPEAT, 1.0, inb & needs

    scene4, cam4, light4, cfg4 = configs.config4_shadow_normal_map(W, H,
                                                                   device=dev)
    cfg4 = cfg4.replace(shadow_map_size=SHADOW)
    samples = tuple(cfg4.sample_positions)
    cams4 = [OrbitCamera(radius=5.0, theta=2.5 + 0.01 * i, phi=1.2,
                         aspect=W / H) for i in range(BATCH)]
    preps4 = [pipeline.prepare_frame(scene4, c, light4, cfg4, device=dev)
              for c in [cam4] + cams4]
    light_m4 = preps4[0].uniforms[:16].reshape(4, 4)
    gout4 = raster_cuda.raster_gbuffer(preps4[0].main_bins, W, H, samples)[0]
    ch4 = raster_cuda.channels_from_gout_px(gout4, len(samples))
    smap4 = raster_cuda.raster_depth(preps4[0].shadow_bins, SHADOW, SHADOW,
                                     center)[0][0]
    mips = scene4.textures[0]
    lod = shade._texture_lod(ch4["u"], ch4["v"], mips[0].shape[1],
                             mips[0].shape[0])
    k9_args = (mip_cuda.build_pyramid(mips), ch4["u"], ch4["v"], lod,
               (ch4["nmid"] == 0) & ch4["covered"], sampling.REPEAT)
    mb48 = raster_cuda.stack_bins([p.main_bins for p in preps4[1:]])
    sb48 = raster_cuda.stack_bins([p.shadow_bins for p in preps4[1:]])
    smaps48 = raster_cuda.raster_depth_batch(sb48, SHADOW, SHADOW,
                                             center)[0][:, 0]
    g48 = raster_cuda.raster_gbuffer_batch(mb48, W, H, samples)
    ch48 = raster_cuda.channels_from_gout_px(g48.transpose(0, 1),
                                             len(samples))
    k8_args = (smaps48, *lookup(ch48, preps4[1].uniforms[:16].reshape(4, 4)))
    del g48, ch48
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW,
                       shading_per_pixel=False)
    prep = pipeline.prepare_frame(audio_app.build_scene(device=dev), cam,
                                  Lighting(light=PointLight(),
                                           ambient_intensity=0.1,
                                           shininess=32.0), cfg,
                                  displacement=0.05,
                                  shadow_target=(0.0, 0.0, -1.0), device=dev)
    smap = raster_cuda.raster_depth(prep.shadow_bins, SHADOW, SHADOW,
                                    center)[0][0]
    g_s, _, w_s = raster_cuda.raster_gbuffer_samples(
        prep.main_bins, W, H, tuple(cfg.sample_positions))
    ch = raster_cuda.channels_from_gout(g_s, w_s)
    del g_s, w_s
    light_m = prep.uniforms[:16].reshape(4, 4)
    return {
        "k7_config4": (*k7, (smap4, *lookup(ch4, light_m4)), 200),
        "k7_ss_px": (*k7, (smap, *lookup(ch, light_m, True)), 200),
        "k7_ss_planes4": (*k7, (smap, *lookup(ch, light_m)), 100),
        "k8_config4x8": (sample_cuda.sample_bilinear_batch,
                         sample_cuda.sample_bilinear_batch_plain, bits_ok,
                         k8_args, 100),
        "k9_config4": (mip_cuda.sample_pyramid, mip_cuda.sample_pyramid_plain,
                       bits_ok, k9_args, 200)}


def one(root, parts, splits, only):
    sys.path.insert(0, str(root))
    import torch
    cs = smoke()
    from metalrenderer_tpu_torch.raster import _build, raster_cuda
    if not Path(raster_cuda.__file__).is_relative_to(root):
        cs.fail(f"imported {raster_cuda.__file__}, not the port under {root}")
    dev = torch.device("cuda:0")
    cases = {}
    for group, build in ((RASTER, lambda: raster_cases(cs, dev)),
                         (CONFIGS, lambda: config_cases(cs, dev)),
                         (SAMPLERS, lambda: sampler_cases(dev))):
        if any(n.startswith(only) for n in group):
            cases.update(build())
    cases = {k: c for k, c in cases.items() if k.startswith(only)}
    # The split walk's threshold and slice (raster_cuda.TILE_SPLIT_ABOVE,
    # TILE_SPLIT_SLICE), in roots that have them: each K2/K3/K5/K6 case
    # also at every (above, slice) of ``splits``.
    auto_split = (getattr(raster_cuda, "TILE_SPLIT_ABOVE", None),
                  getattr(raster_cuda, "TILE_SPLIT_SLICE", None))
    split_forms = [None] + (splits if None not in auto_split else [])
    depth_forms = [("", {})]
    if "with_winner" in inspect.signature(raster_cuda.raster_depth).parameters:
        depth_forms.append(("_nw", {"with_winner": False}))
    auto_parts = getattr(raster_cuda, "_depth_parts", None)
    part_forms = [None] + (parts if auto_parts is not None else [])
    log = (_build.library_path().parent / "build.log").read_text()
    out = {"root": str(root),
           "ptxas": {k: v for k, v in cs.ptxas_summary(log).items()
                     if k.startswith(("render_fused", "raster_gbuffer_kernel",
                                      "raster_depth", "sample_"))}}
    for name, (kernel, plain, check, args, reps) in cases.items():
        forms = [("", {}, None, None)]
        if name[:2] in ("k1", "k4"):
            forms = [(sfx + (f"_p{p}" if p else ""), kw, p, None)
                     for p in part_forms for sfx, kw in depth_forms]
        elif name[:2] in ("k2", "k3", "k5", "k6"):
            forms = [(f"_A{sp[0]}L{sp[1]}" if sp else "", {}, None, sp)
                     for sp in split_forms]
        ref = None if plain is None else plain(*args)
        for suffix, kw, p, sp in forms:
            if auto_parts is not None:
                raster_cuda._depth_parts = (auto_parts if p is None else
                                            lambda bins, frames, p=p: p)
            if None not in auto_split:
                (raster_cuda.TILE_SPLIT_ABOVE,
                 raster_cuda.TILE_SPLIT_SLICE) = sp or auto_split
            res = kernel(*args, **kw)
            ok = None if check is None else check(res, ref)
            torch.cuda.synchronize()
            ms, dev_ms = cs.timings(lambda: kernel(*args, **kw), reps)
            out[name + suffix] = {"ok": ok, "ms": round(ms, 5),
                                  "device_ms": round(dev_ms, 5),
                                  "digest": digest(res)}
            del res
        del ref
    if None not in auto_split:
        raster_cuda.TILE_SPLIT_ABOVE, raster_cuda.TILE_SPLIT_SLICE = \
            auto_split
        out["split_above_slice"] = auto_split
    if auto_parts is not None and any(n[:2] in ("k1", "k4") for n in cases):
        raster_cuda._depth_parts = auto_parts
        out["parts"] = {n: auto_parts(cases[n][3][0], f)
                        for n, f in (("k1_flagship", 1), ("k4_flagship8",
                                                          BATCH))
                        if n in cases}
    print(json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    parts, splits, only = [], [], RASTER + CONFIGS + SAMPLERS
    while args[:1] in (["--parts"], ["--split"], ["--cases"]):
        if args[0] == "--parts":
            parts = [int(p) for p in args[1].split(",")]
        elif args[0] == "--split":
            splits = [tuple(int(v) for v in p.split(":"))
                      for p in args[1].split(",")]
        else:
            only = tuple(args[1].split(","))
        args = args[2:]
    if args[:1] == ["--one"]:
        return one(Path(args[1]).resolve(), parts, splits, only)
    roots = [Path(r).resolve() for r in args] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    opts = ["--cases", ",".join(only)]
    if parts:
        opts += ["--parts", ",".join(map(str, parts))]
    if splits:
        opts += ["--split", ",".join(f"{a}:{l}" for a, l in splits)]
    rc = 0
    for root in roots + roots[::-1]:
        rc |= subprocess.run([sys.executable, __file__, *opts, "--one",
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
