#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (one line each; any failure exits non-zero and prints no result):
  0. environment: the card's name and power limit, torch/CUDA/nvcc versions;
  1. build the kernels from metalrenderer_tpu_torch/csrc with nvcc;
  2. K1 raster_depth against its plain twin on the card: the flagship shadow
     pass (1024^2, the port's own prep) and a seeded soup of a few thousand
     triangles at 1024^2 — winners equal, depth bit-equal;
  3. K2 render_fused against its plain twin on the flagship main pass
     (1920x1080, 4x MSAA) — covered fractions equal, rgba within 1e-5;
  4. an 800x600 flagship frame against tests/goldens/audio_app_800x600.png,
     >= 40 dB PSNR;
  5. serve 16 flagship frames (1920x1080 MSAA4, 1024^2 shadow map,
     displacement linspace(0, 0.05)) through render_audio_app(device="cuda"):
     median ms/frame and Mpixel/s, the prep/kernel split, one launch of each
     fused-path kernel per frame, finite frames, covered_fraction equal to
     the CPU run of the same frame within 1e-6;
  6. K3 raster_gbuffer against its twin on BASELINE config 4's main pass
     (1920x1080 MSAA4, the port's own prep) — per-sample winners equal,
     depth and gout bit-equal;
  7. K7 sample_bilinear against its twin on that frame's shadow lookup
     (its 1024^2 shadow map) — max abs error 0; beside it, the time of one
     torch.nn.functional.grid_sample call on the map padded by one wrapped
     texel (a yardstick only: the port never calls it);
  8. K9 sample_pyramid against its twin on that frame's normal-map lookup
     and on the grass-textured cube's color lookup (1920x1080) — max abs
     error 0;
  9. the grass-textured AudioApp cube at 160x120 on the card against
     tests/goldens/grass_cube_160x120.png, >= 40 dB;
 10. serve 8 config-4 frames (1920x1080 MSAA4, 1024^2 shadow map, the
     camera orbiting by 0.01 rad a frame) through render_frame(device=
     "cuda"): median/min/max ms and Mpixel/s, the prep/kernel split, per
     frame one K1, one K3, one K7, two K9 (the normal-map pass and the
     base-color pass each sample the one texture) and no K2 launch, finite
     frames, covered_fraction equal to the CPU run of the last frame within
     1e-6 and the rgba difference from it;
 11. torch.profiler over 4 frames of each path: CUDA launch calls and device
     events (kernels and copies) per frame, device-busy ms per frame and
     its share of the frame's wall time under the profiler.
Then one JSON line with each kernel's numbers, the nvidia-smi line, and the
result line {"ok": true, "device": {...}}.

Tolerances: K1 and K3 run their twins' exact operation sequence (anchored
planes, every multiply and add rounded on its own: nvcc -fmad=false, eager
torch ops), and so do K7 and K9 (the reference sampler's coordinate and
lerp expressions), so their outputs are bit-equal. K2's shading adds sqrtf,
IEEE division and powf: sqrt and division are correctly rounded on both
sides, and powf is the same libdevice routine in torch's kernel and in
ours, so rgba agrees to float32 rounding; 1e-5 leaves room for a differing
libdevice version. CPU against GPU frames: the prep is device-independent,
but the split path's LOD takes a log2 that CPU and GPU may round one ulp
apart, which moves a trilinear blend weight by ~1e-7: covered fractions
must be equal (1e-6), the rgba difference is reported.

Bounds (bound_ms): the larger of the bytes a launch must move (each input
tensor read once, each output written once) over 3.35 TB/s and its FP32
operations over 67 TFLOP/s (the H100 SXM's published rates at 700 W). The
raster kernels' operations are counted from this run's bins: 16 per
(candidate triangle, sample) — four plane evaluations of two multiplies
and two adds — plus 60 per covered pixel for the 15 attribute planes
(K2, K3); the samplers' per sampled pixel: 18 (K7), 94 (K9).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, SHADOW, FRAMES, FRAMES4 = 1920, 1080, 1024, 16, 8
DEVICE = "cuda:0"
RASTER_SRC = "metalrenderer_tpu_torch/csrc/raster.cu"
SAMPLE_SRC = "metalrenderer_tpu_torch/csrc/sample.cu"
HBM_BYTES_PER_MS = 3.35e9     # 3.35 TB/s
FP32_OPS_PER_MS = 67e9        # 67 TFLOP/s outside the tensor cores


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events, warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_frames(fn, args):
    """fn(a) for each a, each timed with CUDA events; (ms list, outputs)."""
    import torch
    ms, outs = [], []
    for a in args:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        outs.append(fn(a))
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return ms, outs


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bins_bytes(bins, with_attr):
    return nbytes(bins.vis, bins.tile_offsets, bins.tile_tris, bins.big_ids,
                  bins.big_aabb, bins.big_n,
                  bins.attr if with_attr else None)


def raster_ops(bins, width, height, n_samples, covered_px=0):
    """FP32 operations the raster kernels need on these bins: 16 per
    (candidate, sample) of every pixel, 60 per covered pixel."""
    import torch
    from metalrenderer_tpu_torch.raster import raster_cuda
    tiles = torch.arange(bins.ntx * bins.nty, device=bins.vis.device)
    cand = (raster_cuda._candidates(bins, tiles) >= 0).sum(dim=1)
    x0 = (tiles % bins.ntx) * bins.tile_w
    y0 = (tiles // bins.ntx) * bins.tile_h
    npx = (torch.clamp(width - x0, max=bins.tile_w)
           * torch.clamp(height - y0, max=bins.tile_h))
    return 16 * n_samples * int((cand * npx).sum()) + 60 * int(covered_px)


def bound(n_bytes, ops):
    b, o = n_bytes / HBM_BYTES_PER_MS, ops / FP32_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


def psnr_db(fb, golden):
    import numpy as np
    a = np.clip(fb.cpu().numpy()[..., :3], 0, 1)
    b = golden[..., :3].astype(np.float32) / 255.0
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def soup_setup(n, size, seed, device):
    """Seeded clip-space soup at size^2: mostly small triangles, one in 16
    spanning many 64x128 tiles (the big list)."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch.raster.geometry import setup_triangles
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n, 1, 2))
    sc = np.where(np.arange(n) % 16 == 0, rng.uniform(0.3, 1.2, n),
                  rng.uniform(0.005, 0.08, n))[:, None, None]
    pts = c + sc * rng.uniform(-1.0, 1.0, (n, 3, 2))
    z = rng.uniform(0.02, 0.98, (n, 1, 1)) + rng.uniform(-0.02, 0.02, (n, 3, 1))
    w = rng.uniform(0.5, 3.0, (n, 1, 1))
    clip = np.concatenate([pts * w, z * w, np.broadcast_to(w, (n, 3, 1))], -1)
    return setup_triangles(torch.from_numpy(clip.astype(np.float32)).to(device),
                           size, size, cull_backfaces=False)


def profile_frames(fn, args):
    """Per frame under torch.profiler: CUDA launch calls, device events,
    device-busy ms (the device events' summed durations), wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in args:
            fn(a)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    calls = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel",
                                                        "cuLaunchKernel")))
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    n = len(args)
    return {"launch_calls": calls / n, "device_events": len(device) / n,
            "device_busy_ms": busy / n, "wall_ms": wall / n,
            "busy_share": busy / wall}


def reset_counts():
    from metalrenderer_tpu_torch.raster import mip_cuda, raster_cuda, sample_cuda
    for mod in (raster_cuda, sample_cuda, mip_cuda):
        mod.reset_launch_counts()


def read_counts():
    from metalrenderer_tpu_torch.raster import mip_cuda, raster_cuda, sample_cuda
    return {**raster_cuda.LAUNCHES, **sample_cuda.LAUNCHES,
            **mip_cuda.LAUNCHES}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.io import png
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import (_build, binning, mip_cuda,
                                                raster_cuda, sample_cuda,
                                                sampling, shade)
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    from metalrenderer_tpu_torch.scene.materials import BLINN_PHONG_SHADOW

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 could not be turned off")

    # 0. environment --------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()
    say("env", card=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        nvcc=repr(nvcc[-1] if nvcc else "?"),
        devices=torch.cuda.device_count())

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    raster_cuda._lib()
    sample_cuda._lib()
    mip_cuda._lib()
    build_s = time.perf_counter() - t0
    log = (_build.library_path().parent / "build.log").read_text()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "Used" in ln]
    say("build", seconds=f"{build_s:.2f}", lib=_build.library_path().name,
        ptxas=repr(regs))

    # Flagship inputs, built by the port's own prep on the card.
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW)
    lighting = Lighting(light=PointLight(), ambient_intensity=0.1,
                        shininess=32.0)
    scene = audio_app.build_scene(device=dev)
    prep = pipeline.prepare_frame(scene, cam, lighting, cfg,
                                  displacement=0.05,
                                  shadow_target=(0.0, 0.0, -1.0), device=dev)
    center = ((0.5, 0.5),)
    samples = tuple(cfg.sample_positions)
    stats = {}      # per kernel: max_abs_err, ms, plain_ms, bound, library_ms

    # 2. K1 against its twin ------------------------------------------------
    k1_err = 0.0
    soup = soup_setup(4000, SHADOW, seed=7, device=dev)
    soup_bins = binning.bin_triangles(soup, binning.build_tri_fields(soup),
                                      SHADOW, SHADOW, 128, 64)
    for name, bins in (("flagship_shadow", prep.shadow_bins),
                       ("soup4000", soup_bins)):
        d_k, w_k = raster_cuda.raster_depth(bins, SHADOW, SHADOW, center)
        d_p, w_p = raster_cuda.raster_depth_plain(bins, SHADOW, SHADOW, center)
        torch.cuda.synchronize()
        win_eq = torch.equal(w_k, w_p)
        bits_eq = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
        k1_err = max(k1_err, float((d_k - d_p).abs().max()))
        say("k1", case=name, covered=int((w_k >= 0).sum()),
            big_n=int(bins.big_n[0]), big_dropped=int(bins.num_big_dropped),
            winners_equal=win_eq, depth_bit_equal=bits_eq)
        if not (win_eq and bits_eq):
            fail(f"K1 disagrees with its twin on {name}")
        if int((w_k >= 0).sum()) == 0:
            fail(f"K1 covered nothing on {name}")
    sb = prep.shadow_bins
    k1_ms = cuda_ms(lambda: raster_cuda.raster_depth(sb, SHADOW, SHADOW,
                                                     center), 200)
    k1_plain_ms = cuda_ms(lambda: raster_cuda.raster_depth_plain(
        sb, SHADOW, SHADOW, center), 5)
    k1_bound = bound(bins_bytes(sb, False) + nbytes(d_k, w_k),
                     raster_ops(sb, SHADOW, SHADOW, 1))
    say("k1", shape=f"{SHADOW}x{SHADOW}x1", ms=f"{k1_ms:.4f}",
        plain_ms=f"{k1_plain_ms:.4f}", bound_ms=f"{k1_bound[0]:.5f}",
        bound_by=k1_bound[1], card=repr(smi))
    stats["raster_depth"] = (k1_err, k1_ms, k1_plain_ms, k1_bound, None)

    # 3. K2 against its twin ------------------------------------------------
    shadow_map = raster_cuda.raster_depth(sb, SHADOW, SHADOW, center)[0][0]
    mb, uni = prep.main_bins, prep.uniforms
    rgba_k, covf_k = raster_cuda.render_fused(mb, uni, shadow_map, W, H,
                                              samples)
    rgba_p, covf_p = raster_cuda.render_fused_plain(mb, uni, shadow_map, W, H,
                                                    samples)
    torch.cuda.synchronize()
    k2_err = float((rgba_k - rgba_p).abs().max())
    covf_eq = torch.equal(covf_k, covf_p)
    say("k2", shape=f"{W}x{H}xS4", triangles=mb.vis.shape[0],
        big_n=int(mb.big_n[0]), covf_equal=covf_eq,
        rgba_max_abs_err=k2_err, tol=1e-5)
    if not covf_eq or not k2_err <= 1e-5:
        fail("K2 disagrees with its twin")
    k2_ms = cuda_ms(lambda: raster_cuda.render_fused(mb, uni, shadow_map, W, H,
                                                     samples), 100)
    k2_plain_ms = cuda_ms(lambda: raster_cuda.render_fused_plain(
        mb, uni, shadow_map, W, H, samples), 3)
    k2_bound = bound(
        bins_bytes(mb, True) + nbytes(uni, shadow_map, rgba_k, covf_k),
        raster_ops(mb, W, H, len(samples), int((covf_k > 0).sum())))
    say("k2", ms=f"{k2_ms:.4f}", plain_ms=f"{k2_plain_ms:.4f}",
        bound_ms=f"{k2_bound[0]:.5f}", bound_by=k2_bound[1], card=repr(smi))
    stats["render_fused"] = (k2_err, k2_ms, k2_plain_ms, k2_bound, None)

    # 4. golden --------------------------------------------------------------
    gcfg = RenderConfig(width=800, height=600, msaa=4, shadow_map_size=1024)
    gcam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=800 / 600)
    fb, _ = audio_app.render_audio_app(camera=gcam, config=gcfg, device=dev)
    psnr = psnr_db(fb, png.read_png(ROOT / "tests" / "goldens"
                                    / "audio_app_800x600.png"))
    say("golden", size="800x600", psnr_db=f"{psnr:.3f}", bar=40)
    if not psnr >= 40.0:
        fail(f"golden PSNR {psnr:.3f} dB < 40")

    # 5. serve the flagship ---------------------------------------------------
    disps = [float(d) for d in np.linspace(0.0, 0.05, FRAMES)]

    def frame(d):
        return audio_app.render_audio_app(displacement=d, camera=cam,
                                          config=cfg, device=dev, scene=scene)

    frame(disps[0])                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    frame_ms, outs = timed_frames(frame, disps)
    launches = read_counts()
    prep_ms, _ = timed_frames(lambda d: pipeline.prepare_frame(
        scene, cam, lighting, cfg, displacement=d,
        shadow_target=(0.0, 0.0, -1.0), device=dev), disps)
    med = statistics.median(frame_ms)
    med_prep = statistics.median(prep_ms)
    finite = all(bool(torch.isfinite(fb).all()) for fb, _ in outs)
    shapes_ok = all(tuple(fb.shape) == (H, W, 4) for fb, _ in outs)
    covf_gpu = float(outs[-1][1]["covered_fraction"])
    fb_cpu, st_cpu = audio_app.render_audio_app(
        displacement=disps[-1], camera=cam, config=cfg, device="cpu")
    covf_cpu = float(st_cpu["covered_fraction"])
    cpu_gpu_err = float((outs[-1][0].cpu() - fb_cpu).abs().max())
    say("serve", frames=FRAMES, size=f"{W}x{H}", msaa=4, shadow=SHADOW,
        median_ms=f"{med:.4f}", mpix_s=f"{W * H / med / 1e3:.3f}",
        min_ms=f"{min(frame_ms):.4f}", max_ms=f"{max(frame_ms):.4f}",
        card=repr(smi))
    say("serve", split="median ms", prep_ms=f"{med_prep:.4f}",
        k1_ms=f"{k1_ms:.4f}", k2_ms=f"{k2_ms:.4f}",
        rest_ms=f"{med - med_prep - k1_ms - k2_ms:.4f}")
    say("serve", launches=json.dumps(launches), finite=finite,
        shapes_ok=shapes_ok, covered_fraction_gpu=covf_gpu,
        covered_fraction_cpu=covf_cpu, rgba_max_abs_err_vs_cpu=cpu_gpu_err)
    want = {k: 0 for k in launches}
    want.update(raster_depth=FRAMES, render_fused=FRAMES)
    if launches != want:
        fail(f"launch counts {launches} != one per fused-path kernel per frame")
    if not (finite and shapes_ok):
        fail("non-finite or misshapen frames")
    if not abs(covf_gpu - covf_cpu) <= 1e-6:
        fail(f"covered_fraction {covf_gpu} (GPU) vs {covf_cpu} (CPU)")
    path_launches = dict(launches)

    # Config-4 inputs (split path), built by the port's own prep on the card.
    scene4, cam4, light4, cfg4 = configs.config4_shadow_normal_map(W, H,
                                                                   device=dev)
    cfg4 = cfg4.replace(shadow_map_size=SHADOW)
    prep4 = pipeline.prepare_frame(scene4, cam4, light4, cfg4, device=dev)
    smap4 = raster_cuda.raster_depth(prep4.shadow_bins, SHADOW, SHADOW,
                                     center)[0][0]
    mb4 = prep4.main_bins

    # 6. K3 against its twin ------------------------------------------------
    out_k = raster_cuda.raster_gbuffer(mb4, W, H, samples, with_samples=True)
    out_p = raster_cuda.raster_gbuffer_plain(mb4, W, H, samples,
                                             with_samples=True)
    torch.cuda.synchronize()
    gout_k, d_k, w_k = out_k
    gout_p, d_p, w_p = out_p
    win_eq = torch.equal(w_k, w_p)
    depth_eq = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    gout_eq = torch.equal(gout_k.view(torch.int32), gout_p.view(torch.int32))
    cnt_eq = torch.equal(gout_k[binning.ROW_DEPTH], gout_p[binning.ROW_DEPTH])
    k3_err = float((gout_k - gout_p).abs().max())
    covered4 = int((gout_k[binning.ROW_DEPTH] > 0).sum())
    say("k3", case="config4_main", shape=f"{W}x{H}xS4",
        triangles=mb4.vis.shape[0], big_n=int(mb4.big_n[0]),
        covered_px=covered4, winners_equal=win_eq, depth_bit_equal=depth_eq,
        gout_bit_equal=gout_eq, counts_equal=cnt_eq, max_abs_err=k3_err)
    if not (win_eq and depth_eq and gout_eq and cnt_eq):
        fail("K3 disagrees with its twin")
    if covered4 == 0:
        fail("K3 covered nothing")
    k3_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer(mb4, W, H, samples),
                    100)
    k3_plain_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_plain(
        mb4, W, H, samples), 3)
    k3_bound = bound(bins_bytes(mb4, True) + nbytes(gout_k),
                     raster_ops(mb4, W, H, len(samples), covered4))
    say("k3", ms=f"{k3_ms:.4f}", plain_ms=f"{k3_plain_ms:.4f}",
        bound_ms=f"{k3_bound[0]:.5f}", bound_by=k3_bound[1], card=repr(smi))
    stats["raster_gbuffer"] = (k3_err, k3_ms, k3_plain_ms, k3_bound, None)

    # 7. K7 against its twin: the config-4 frame's shadow lookup -------------
    ch4 = raster_cuda.channels_from_gout_px(gout_k, len(samples))
    w4 = (ch4["wx"], ch4["wy"], ch4["wz"])
    light_m = prep4.uniforms[:16].reshape(4, 4)
    su, sv, _, inb = shade._shadow_coords(w4, light_m)
    smask = inb & (ch4["kind"] == BLINN_PHONG_SHADOW) & ch4["covered"]
    d_k = sample_cuda.sample_bilinear(smap4, su, sv, sampling.REPEAT, 1.0,
                                      smask)
    d_p = sample_cuda.sample_bilinear_plain(smap4, su, sv, sampling.REPEAT,
                                            1.0, smask)
    torch.cuda.synchronize()
    k7_err = float((d_k - d_p).abs().max())
    sampled7 = int(smask.sum())
    say("k7", case="config4_shadow_lookup", map=f"{SHADOW}x{SHADOW}",
        grid=f"{W}x{H}", sampled_px=sampled7, max_abs_err=k7_err, tol=0)
    if not k7_err == 0.0 or sampled7 == 0:
        fail("K7 disagrees with its twin (or sampled nothing)")
    k7_ms = cuda_ms(lambda: sample_cuda.sample_bilinear(
        smap4, su, sv, sampling.REPEAT, 1.0, smask), 200)
    k7_plain_ms = cuda_ms(lambda: sample_cuda.sample_bilinear_plain(
        smap4, su, sv, sampling.REPEAT, 1.0, smask), 20)
    # Yardstick: one grid_sample call (bilinear, align_corners=False) on
    # the map padded by one wrapped texel, at the same coordinates.
    padded = torch.cat([smap4[:, -1:], smap4, smap4[:, :1]], dim=1)
    padded = torch.cat([padded[-1:], padded, padded[:1]], dim=0)[None, None]
    gx = ((su * SHADOW + 1.0) / (SHADOW + 2)) * 2.0 - 1.0
    gy = ((sv * SHADOW + 1.0) / (SHADOW + 2)) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None].contiguous()

    def grid_sample():
        return torch.nn.functional.grid_sample(
            padded, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    lib_err = float((grid_sample()[0, 0] - d_k).abs()[smask].max())
    k7_lib_ms = cuda_ms(grid_sample, 200)
    k7_bound = bound(nbytes(smap4, su, sv, smask, d_k), 18 * sampled7)
    say("k7", ms=f"{k7_ms:.4f}", plain_ms=f"{k7_plain_ms:.4f}",
        library_ms=f"{k7_lib_ms:.4f}", library_max_abs_err=lib_err,
        bound_ms=f"{k7_bound[0]:.5f}", bound_by=k7_bound[1], card=repr(smi))
    stats["sample_bilinear"] = (k7_err, k7_ms, k7_plain_ms, k7_bound,
                                k7_lib_ms)

    # 8. K9 against its twin: config 4's normal map, the grass cube's color --
    gscene = audio_app.build_scene(textures=(audio_app.grass_texture(),),
                                   cube_texture_id=0, device=dev)
    gprep = pipeline.prepare_frame(gscene, cam, lighting, cfg,
                                   shadow_target=(0.0, 0.0, -1.0), device=dev)
    gch = raster_cuda.channels_from_gout_px(
        raster_cuda.raster_gbuffer(gprep.main_bins, W, H, samples)[0],
        len(samples))
    cases9 = []
    for name, mips, ch, sel in (
            ("config4_normal_map", scene4.textures[0], ch4, "nmid"),
            ("grass_cube_color", gscene.textures[0], gch, "texid")):
        pyr = mip_cuda.build_pyramid(mips)
        lod = shade._texture_lod(ch["u"], ch["v"], mips[0].shape[1],
                                 mips[0].shape[0])
        mask = (ch[sel] == 0) & ch["covered"]
        args = (pyr, ch["u"], ch["v"], lod, mask, sampling.REPEAT)
        k = mip_cuda.sample_pyramid(*args)
        p = mip_cuda.sample_pyramid_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(k, p))
        sampled = int(mask.sum())
        say("k9", case=name, texture=f"{mips[0].shape[1]}x{mips[0].shape[0]}",
            levels=len(mips), grid=f"{W}x{H}", sampled_px=sampled,
            max_abs_err=err, tol=0)
        if not err == 0.0 or sampled == 0:
            fail(f"K9 disagrees with its twin on {name} (or sampled nothing)")
        cases9.append((name, args, err, sampled, k))
    _, args9, _, sampled9, out9 = cases9[0]     # the config-4 path's launch
    k9_err = max(c[2] for c in cases9)
    k9_ms = cuda_ms(lambda: mip_cuda.sample_pyramid(*args9), 200)
    k9_plain_ms = cuda_ms(lambda: mip_cuda.sample_pyramid_plain(*args9), 20)
    pyr9, u9, v9, lod9, mask9, _ = args9
    k9_bound = bound(nbytes(pyr9.texels, u9, v9, lod9, mask9, *out9),
                     94 * sampled9)
    k9_grass_ms = cuda_ms(lambda: mip_cuda.sample_pyramid(*cases9[1][1]), 200)
    say("k9", case="config4_normal_map", ms=f"{k9_ms:.4f}",
        plain_ms=f"{k9_plain_ms:.4f}", bound_ms=f"{k9_bound[0]:.5f}",
        bound_by=k9_bound[1], grass_cube_color_ms=f"{k9_grass_ms:.4f}",
        card=repr(smi))
    stats["sample_pyramid"] = (k9_err, k9_ms, k9_plain_ms, k9_bound, None)

    # 9. grass-cube golden ---------------------------------------------------
    fb, _ = audio_app.render_audio_app(
        camera=OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=160 / 120),
        config=RenderConfig(width=160, height=120, msaa=4,
                            shadow_map_size=128),
        textures=(audio_app.grass_texture(),), cube_texture_id=0, device=dev)
    psnr = psnr_db(fb, png.read_png(ROOT / "tests" / "goldens"
                                    / "grass_cube_160x120.png"))
    say("golden", size="160x120", scene="grass_cube", psnr_db=f"{psnr:.3f}",
        bar=40)
    if not psnr >= 40.0:
        fail(f"grass golden PSNR {psnr:.3f} dB < 40")

    # 10. serve config 4 ------------------------------------------------------
    cams4 = [OrbitCamera(radius=5.0, theta=2.5 + 0.01 * i, phi=1.2,
                         aspect=W / H) for i in range(FRAMES4)]

    def frame4(c):
        return pipeline.render_frame(scene4, c, light4, cfg4, device=dev)

    frame4(cams4[0])                                  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    frame_ms, outs = timed_frames(frame4, cams4)
    launches = read_counts()
    prep_ms, _ = timed_frames(lambda c: pipeline.prepare_frame(
        scene4, c, light4, cfg4, device=dev), cams4)
    med = statistics.median(frame_ms)
    med_prep = statistics.median(prep_ms)
    finite = all(bool(torch.isfinite(fb).all()) for fb, _ in outs)
    shapes_ok = all(tuple(fb.shape) == (H, W, 4) for fb, _ in outs)
    covf_gpu = float(outs[-1][1]["covered_fraction"])
    fb_cpu, st_cpu = pipeline.render_frame(scene4, cams4[-1], light4, cfg4,
                                           device="cpu")
    covf_cpu = float(st_cpu["covered_fraction"])
    cpu_gpu_err = float((outs[-1][0].cpu() - fb_cpu).abs().max())
    kernels_ms = k1_ms + k3_ms + k7_ms + 2 * k9_ms
    say("serve4", frames=FRAMES4, size=f"{W}x{H}", msaa=4, shadow=SHADOW,
        median_ms=f"{med:.4f}", mpix_s=f"{W * H / med / 1e3:.3f}",
        min_ms=f"{min(frame_ms):.4f}", max_ms=f"{max(frame_ms):.4f}",
        card=repr(smi))
    say("serve4", split="median ms", prep_ms=f"{med_prep:.4f}",
        kernels_ms=f"{kernels_ms:.4f}",
        rest_ms=f"{med - med_prep - kernels_ms:.4f}")
    say("serve4", launches=json.dumps(launches), finite=finite,
        shapes_ok=shapes_ok, covered_fraction_gpu=covf_gpu,
        covered_fraction_cpu=covf_cpu, rgba_max_abs_err_vs_cpu=cpu_gpu_err)
    want = {k: 0 for k in launches}
    want.update(raster_depth=FRAMES4, raster_gbuffer=FRAMES4,
                sample_bilinear=FRAMES4, sample_pyramid=2 * FRAMES4)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    if not (finite and shapes_ok):
        fail("non-finite or misshapen config-4 frames")
    if not abs(covf_gpu - covf_cpu) <= 1e-6:
        fail(f"config-4 covered_fraction {covf_gpu} (GPU) vs {covf_cpu} (CPU)")
    for k, n in launches.items():
        path_launches[k] += n

    # 11. profile both paths -------------------------------------------------
    for name, fn, args in (("flagship", frame, disps[:4]),
                           ("config4", frame4, cams4[:4])):
        prof = profile_frames(fn, args)
        say("profile", path=name, frames=len(args),
            **{k: f"{v:.4f}" for k, v in prof.items()}, card=repr(smi))

    meta = {"raster_depth": (RASTER_SRC, "raster_pallas.py:865"),
            "render_fused": (RASTER_SRC, "raster_pallas.py:997"),
            "raster_gbuffer": (RASTER_SRC, "raster_pallas.py:865"),
            "sample_bilinear": (SAMPLE_SRC, "sample_pallas.py:642"),
            "sample_pyramid": (SAMPLE_SRC, "mip_pallas.py:475")}
    kernels = []
    for name, (src, tpu) in meta.items():
        err, ms, plain_ms, (bound_ms, bound_by), lib_ms = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"metalrenderer_tpu/raster/{tpu}",
            "launches": path_launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
