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
     its share of the frame's wall time under the profiler;
 12. K4 raster_depth_batch against its twin on 8 flagship shadow passes at
     1024^2 (displacements linspace(0, 0.05, 7) and 5.0; the last frame,
     seen from theta 2.2, near-clips heavily) — winners equal, depth
     bit-equal, and bit-equal to eight K1 launches on the same bins;
 13. K6 render_fused_batch against its twin on that batch's main passes
     (1920x1080 MSAA4, K4's shadow maps) — covered fractions equal, rgba
     within 1e-5, and bit-equal to eight K2 launches;
 14. K5 raster_gbuffer_batch against its twin on 8 config-4 frames (the
     camera orbiting by 0.01 rad a frame) — gout bit-equal, and bit-equal
     to eight K3 launches;
 15. K8 sample_bilinear_batch against its twin on those frames' shadow
     lookups (their own 1024^2 maps) — max abs error 0, and bit-equal to
     eight K7 launches; beside it, the time of one grid_sample call on the
     eight padded maps at the eight frames' coordinates (as in phase 7);
 16. serve batches of 8 frames through render_batch(device="cuda"): the
     flagship (displacements linspace(0, 0.05, 8)) and config 4 (phase
     10's cameras): median/min/max ms per batch and per frame, Mpixel/s;
     per batch one K4 and one K6 (flagship), or one K4, one K5, one K8 and
     two K9 (config 4), and no per-frame kernel; every batch frame
     bit-equal to render_frame of the same frame on the card; the last
     frame's covered_fraction equal to the CPU run (phases 5 and 10)
     within 1e-6; beside them, per frame, the prep alone and render_frame
     looped over the same frames, and render_frame_batch_hoisted's ms on
     the flagship frames (prep for all frames, then one K1 + K2 per
     frame);
 17. torch.profiler over one batch of each branch: launch calls and
     device-busy ms per frame, as in phase 11.
Then one JSON line with each kernel's numbers, the nvidia-smi line, and the
result line {"ok": true, "device": {...}}.

Tolerances: K1 and K3 run their twins' exact operation sequence (anchored
planes, every multiply and add rounded on its own: nvcc -fmad=false, eager
torch ops), and so do K7 and K9 (the reference sampler's coordinate and
lerp expressions), so their outputs are bit-equal. K2's shading adds
sqrtf, IEEE division and powf: sqrt and division are correctly rounded on
both sides, and powf is the same libdevice routine in torch's kernel and
in ours, so rgba agrees to float32 rounding; 1e-5 leaves room for a
differing libdevice version. K4, K5, K6 and K8 run the per-frame kernels'
code on each frame's slice of the stacked tables, so each batch frame is
bit-equal to the per-frame launch, K4, K5 and K8 bit-equal to their twins
(the per-frame twins frame by frame) and K6 within K2's 1e-5 of its
twin. CPU against GPU frames: the prep is device-independent,
but the split path's LOD takes a log2 that CPU and GPU may round one ulp
apart, which moves a trilinear blend weight by ~1e-7: covered fractions
must be equal (1e-6), the rgba difference is reported.

Bounds (bound_ms): the larger of the bytes a launch must move (each input
tensor read once, each output written once) over 3.35 TB/s and its FP32
operations over 67 TFLOP/s (the H100 SXM's published rates at 700 W). The
raster kernels' operations are counted from this run's bins: 16 per
(candidate triangle, sample) — four plane evaluations of two multiplies
and two adds — plus 60 per covered pixel for the 15 attribute planes
(K2, K3); the samplers' per sampled pixel: 18 (K7), 94 (K9). The
samplers read u, v (and K9 its LOD) only where the mask is set, so their
bytes count 8 (K7, K8) or 12 (K9) per sampled pixel, plus the whole
texture, mask and output. A batch kernel's bound counts every frame's
bytes and operations (K4, K5, K6 as K1, K3, K2 summed over the frames;
K8 as K7).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, SHADOW, FRAMES, FRAMES4 = 1920, 1080, 1024, 16, 8
BATCH, BATCHES = 8, 4      # frames per served batch, batches timed
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


def wrapped_grid_sample(maps, u, v):
    """A yardstick for K7/K8: one torch.nn.functional.grid_sample call
    (bilinear, align_corners=False; batch item f samples maps[f]) on the
    square maps f32[F,S,S] padded by one wrapped texel, at the REPEAT
    coordinates u, v f32[F,H,W]. Returns the call; it yields f32[F,1,H,W]."""
    import torch
    s = maps.shape[-1]
    padded = torch.cat([maps[..., -1:], maps, maps[..., :1]], dim=-1)
    padded = torch.cat([padded[:, -1:], padded, padded[:, :1]],
                       dim=1)[:, None].contiguous()
    gx = ((u * s + 1.0) / (s + 2)) * 2.0 - 1.0
    gy = ((v * s + 1.0) / (s + 2)) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1).contiguous()

    def call():
        return torch.nn.functional.grid_sample(
            padded, grid, mode="bilinear", padding_mode="border",
            align_corners=False)
    return call


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


def profile_batch(fn, frames):
    """profile_frames over one call of fn, a batch of ``frames`` frames:
    its counts and times per frame."""
    prof = profile_frames(lambda _: fn(), [None])
    return {k: v if k == "busy_share" else v / frames
            for k, v in prof.items()}


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
    from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
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
    covf_cpu_flagship = covf_cpu

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
    grid_sample = wrapped_grid_sample(smap4[None], su[None], sv[None])
    lib_err = float((grid_sample()[0, 0] - d_k).abs()[smask].max())
    k7_lib_ms = cuda_ms(grid_sample, 200)
    # u and v are read only where the mask is set: 8 bytes per sampled px.
    k7_bound = bound(nbytes(smap4, smask, d_k) + 8 * sampled7,
                     18 * sampled7)
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
    pyr9, mask9 = args9[0], args9[4]
    k9_bound = bound(nbytes(pyr9.texels, mask9, *out9) + 12 * sampled9,
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
    covf_cpu_config4 = covf_cpu

    # 11. profile both paths -------------------------------------------------
    for name, fn, args in (("flagship", frame, disps[:4]),
                           ("config4", frame4, cams4[:4])):
        prof = profile_frames(fn, args)
        say("profile", path=name, frames=len(args),
            **{k: f"{v:.4f}" for k, v in prof.items()}, card=repr(smi))

    # 12. K4 against its twin: 8 flagship shadow passes ---------------------
    # The last frame's cube, blown up by displacement 5.0 and seen from
    # theta 2.2, reaches past the camera: its main pass near-clips heavily.
    disps8 = [float(d) for d in np.linspace(0.0, 0.05, BATCH - 1)] + [5.0]
    cams_k = [cam] * (BATCH - 1) + [dataclasses.replace(cam, theta=2.2)]
    preps8 = [pipeline.prepare_frame(scene, c, lighting, cfg,
                                     displacement=d,
                                     shadow_target=(0.0, 0.0, -1.0),
                                     device=dev)
              for d, c in zip(disps8, cams_k)]
    sb8 = raster_cuda.stack_bins([p.shadow_bins for p in preps8])
    d_k, w_k = raster_cuda.raster_depth_batch(sb8, SHADOW, SHADOW, center)
    d_p, w_p = raster_cuda.raster_depth_batch_plain(sb8, SHADOW, SHADOW,
                                                    center)
    k1_eq = True
    for f, p in enumerate(preps8):
        d1, w1 = raster_cuda.raster_depth(p.shadow_bins, SHADOW, SHADOW,
                                          center)
        k1_eq &= (torch.equal(d1.view(torch.int32), d_k[f].view(torch.int32))
                  and torch.equal(w1, w_k[f]))
    torch.cuda.synchronize()
    win_eq = torch.equal(w_k, w_p)
    bits_eq = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    k4_err = float((d_k - d_p).abs().max())
    say("k4", frames=BATCH, shape=f"{BATCH}x{SHADOW}x{SHADOW}x1",
        covered=int((w_k >= 0).sum()), big_n=sb8.big_n.tolist(),
        winners_equal=win_eq, depth_bit_equal=bits_eq, equal_to_k1=k1_eq)
    if not (win_eq and bits_eq and k1_eq):
        fail("K4 disagrees with its twin or with K1")
    k4_ms = cuda_ms(lambda: raster_cuda.raster_depth_batch(
        sb8, SHADOW, SHADOW, center), 100)
    k4_plain_ms = cuda_ms(lambda: raster_cuda.raster_depth_batch_plain(
        sb8, SHADOW, SHADOW, center), 2)
    k4_bound = bound(bins_bytes(sb8, False) + nbytes(d_k, w_k),
                     sum(raster_ops(raster_cuda.frame_bins(sb8, f), SHADOW,
                                    SHADOW, 1)
                         for f in range(BATCH)))
    say("k4", ms=f"{k4_ms:.4f}", plain_ms=f"{k4_plain_ms:.4f}",
        per_frame_ms=f"{k4_ms / BATCH:.4f}", bound_ms=f"{k4_bound[0]:.5f}",
        bound_by=k4_bound[1], card=repr(smi))
    stats["raster_depth_batch"] = (k4_err, k4_ms, k4_plain_ms, k4_bound, None)

    # 13. K6 against its twin: that batch's main passes -----------------------
    mb8 = raster_cuda.stack_bins([p.main_bins for p in preps8])
    uni8 = torch.stack([p.uniforms for p in preps8])
    smaps8 = d_k[:, 0]
    r_k, c_k = raster_cuda.render_fused_batch(mb8, uni8, smaps8, W, H,
                                              samples)
    r_p, c_p = raster_cuda.render_fused_batch_plain(mb8, uni8, smaps8, W, H,
                                                    samples)
    k2_eq = True
    for f, p in enumerate(preps8):
        r2, c2 = raster_cuda.render_fused(p.main_bins, p.uniforms, smaps8[f],
                                          W, H, samples)
        k2_eq &= torch.equal(r2, r_k[f]) and torch.equal(c2, c_k[f])
    torch.cuda.synchronize()
    k6_err = float((r_k - r_p).abs().max())
    covf_eq = torch.equal(c_k, c_p)
    covered6 = [int((c_k[f] > 0).sum()) for f in range(BATCH)]
    say("k6", frames=BATCH, shape=f"{BATCH}x{W}x{H}xS4",
        covered_fraction=[round(float(c.mean()), 6) for c in c_k],
        covf_equal=covf_eq, rgba_max_abs_err=k6_err, tol=1e-5,
        equal_to_k2=k2_eq)
    if not (covf_eq and k6_err <= 1e-5 and k2_eq):
        fail("K6 disagrees with its twin or with K2")
    del r_p, c_p
    k6_ms = cuda_ms(lambda: raster_cuda.render_fused_batch(
        mb8, uni8, smaps8, W, H, samples), 50)
    k6_plain_ms = cuda_ms(lambda: raster_cuda.render_fused_batch_plain(
        mb8, uni8, smaps8, W, H, samples), 1)
    k6_bound = bound(
        bins_bytes(mb8, True) + nbytes(uni8, smaps8, r_k, c_k),
        sum(raster_ops(raster_cuda.frame_bins(mb8, f), W, H, len(samples),
                       covered6[f])
            for f in range(BATCH)))
    say("k6", ms=f"{k6_ms:.4f}", plain_ms=f"{k6_plain_ms:.4f}",
        per_frame_ms=f"{k6_ms / BATCH:.4f}", bound_ms=f"{k6_bound[0]:.5f}",
        bound_by=k6_bound[1], card=repr(smi))
    stats["render_fused_batch"] = (k6_err, k6_ms, k6_plain_ms, k6_bound, None)
    del r_k, c_k

    # 14. K5 against its twin: 8 config-4 frames ------------------------------
    cams8 = cams4[:BATCH]
    preps48 = [pipeline.prepare_frame(scene4, c, light4, cfg4, device=dev)
               for c in cams8]
    mb48 = raster_cuda.stack_bins([p.main_bins for p in preps48])
    g_k = raster_cuda.raster_gbuffer_batch(mb48, W, H, samples)
    g_p = raster_cuda.raster_gbuffer_batch_plain(mb48, W, H, samples)
    torch.cuda.synchronize()
    gout_eq = torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
    k5_err = float((g_k - g_p).abs().max())
    del g_p
    k3_eq = True
    for f, p in enumerate(preps48):
        g3 = raster_cuda.raster_gbuffer(p.main_bins, W, H, samples)[0]
        k3_eq &= torch.equal(g3.view(torch.int32), g_k[f].view(torch.int32))
    covered5 = [int((g_k[f, binning.ROW_DEPTH] > 0).sum())
                for f in range(BATCH)]
    say("k5", frames=BATCH, shape=f"{BATCH}x16x{W}x{H}xS4",
        gout_bytes=nbytes(g_k), covered_px=covered5, gout_bit_equal=gout_eq,
        equal_to_k3=k3_eq, max_abs_err=k5_err)
    if not (gout_eq and k3_eq):
        fail("K5 disagrees with its twin or with K3")
    if min(covered5) == 0:
        fail("K5 covered nothing in a frame")
    k5_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_batch(
        mb48, W, H, samples), 50)
    k5_plain_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_batch_plain(
        mb48, W, H, samples), 1)
    k5_bound = bound(bins_bytes(mb48, True) + nbytes(g_k),
                     sum(raster_ops(raster_cuda.frame_bins(mb48, f), W, H,
                                    len(samples), covered5[f])
                         for f in range(BATCH)))
    say("k5", ms=f"{k5_ms:.4f}", plain_ms=f"{k5_plain_ms:.4f}",
        per_frame_ms=f"{k5_ms / BATCH:.4f}", bound_ms=f"{k5_bound[0]:.5f}",
        bound_by=k5_bound[1], card=repr(smi))
    stats["raster_gbuffer_batch"] = (k5_err, k5_ms, k5_plain_ms, k5_bound,
                                     None)

    # 15. K8 against its twin: those frames' shadow lookups ------------------
    sb48 = raster_cuda.stack_bins([p.shadow_bins for p in preps48])
    smaps48 = raster_cuda.raster_depth_batch(sb48, SHADOW, SHADOW,
                                             center)[0][:, 0]
    ch48 = raster_cuda.channels_from_gout_px(g_k.transpose(0, 1),
                                             len(samples))
    su, sv, _, inb = shade._shadow_coords(
        (ch48["wx"], ch48["wy"], ch48["wz"]),
        preps48[0].uniforms[:16].reshape(4, 4))
    smask = inb & (ch48["kind"] == BLINN_PHONG_SHADOW) & ch48["covered"]
    del ch48, g_k
    s_args = (smaps48, su, sv, sampling.REPEAT, 1.0, smask)
    s_k = sample_cuda.sample_bilinear_batch(*s_args)
    s_p = sample_cuda.sample_bilinear_batch_plain(*s_args)
    k7_eq = True
    for f in range(BATCH):
        s7 = sample_cuda.sample_bilinear(
            smaps48[f], su[f].contiguous(), sv[f].contiguous(),
            sampling.REPEAT, 1.0, smask[f].contiguous())
        k7_eq &= torch.equal(s7, s_k[f])
    torch.cuda.synchronize()
    k8_err = float((s_k - s_p).abs().max())
    sampled8 = int(smask.sum())
    say("k8", frames=BATCH, maps=f"{BATCH}x{SHADOW}x{SHADOW}",
        grid=f"{BATCH}x{W}x{H}", sampled_px=sampled8, max_abs_err=k8_err,
        tol=0, equal_to_k7=k7_eq)
    if not (k8_err == 0.0 and k7_eq) or sampled8 == 0:
        fail("K8 disagrees with its twin or with K7 (or sampled nothing)")
    k8_ms = cuda_ms(lambda: sample_cuda.sample_bilinear_batch(*s_args), 100)
    k8_plain_ms = cuda_ms(lambda: sample_cuda.sample_bilinear_batch_plain(
        *s_args), 5)
    grid_sample = wrapped_grid_sample(smaps48, su, sv)
    lib_err = float((grid_sample()[:, 0] - s_k).abs()[smask].max())
    k8_lib_ms = cuda_ms(grid_sample, 100)
    del grid_sample
    k8_bound = bound(nbytes(smaps48, smask, s_k) + 8 * sampled8,
                     18 * sampled8)
    say("k8", ms=f"{k8_ms:.4f}", plain_ms=f"{k8_plain_ms:.4f}",
        per_frame_ms=f"{k8_ms / BATCH:.4f}", library_ms=f"{k8_lib_ms:.4f}",
        library_max_abs_err=lib_err, bound_ms=f"{k8_bound[0]:.5f}",
        bound_by=k8_bound[1], card=repr(smi))
    stats["sample_bilinear_batch"] = (k8_err, k8_ms, k8_plain_ms, k8_bound,
                                      k8_lib_ms)
    del s_args, s_k, s_p, su, sv, smask

    # 16. serve batches through render_batch ---------------------------------
    sdisps = [float(d) for d in np.linspace(0.0, 0.05, BATCH)]
    thetas8 = [cam.theta] * BATCH
    zeros8 = [0.0] * BATCH
    shadow_cfg = ShadowConfig()

    def batch_flagship():
        return pipeline.render_batch(scene, cam, lighting, sdisps, thetas8,
                                     config=cfg, device=dev)

    def batch_config4():
        return pipeline.render_batch(scene4, cam4, light4, zeros8,
                                     config=cfg4, cameras=cams8,
                                     shadow_target=(0.0, 0.0, 0.0),
                                     device=dev)

    def hoisted():
        return pipeline.render_frame_batch_hoisted(
            scene, cam, lighting, cfg, shadow_cfg, sdisps, thetas8,
            device=dev)

    singles = {
        "flagship": lambda i: pipeline.render_frame(
            scene, cam, lighting, cfg, displacement=sdisps[i],
            shadow_target=(0.0, 0.0, -1.0), device=dev),
        "config4": lambda i: pipeline.render_frame(
            scene4, cams8[i], light4, cfg4, device=dev)}
    preps = {
        "flagship": lambda i: pipeline.prepare_frame(
            scene, cam, lighting, cfg, displacement=sdisps[i],
            shadow_target=(0.0, 0.0, -1.0), device=dev),
        "config4": lambda i: pipeline.prepare_frame(
            scene4, cams8[i], light4, cfg4, device=dev)}
    want_batch = {
        "flagship": dict(raster_depth_batch=1, render_fused_batch=1),
        "config4": dict(raster_depth_batch=1, raster_gbuffer_batch=1,
                        sample_bilinear_batch=1, sample_pyramid=2)}
    covf_cpu_last = {"flagship": covf_cpu_flagship,
                     "config4": covf_cpu_config4}
    for name, fn in (("flagship", batch_flagship),
                     ("config4", batch_config4)):
        fn()                                          # warm-up
        torch.cuda.synchronize()
        reset_counts()
        batch_ms, outs = timed_frames(lambda _: fn(), range(BATCHES))
        launches = read_counts()
        rgba, st = outs[-1]
        del outs
        med = statistics.median(batch_ms)
        finite = bool(torch.isfinite(rgba).all())
        shapes_ok = tuple(rgba.shape) == (BATCH, H, W, 4)
        # The same frames one by one, and their prep alone, in this call.
        single_ms, single_outs = timed_frames(singles[name], range(BATCH))
        frames_eq = all(torch.equal(fb, rgba[i])
                        for i, (fb, _) in enumerate(single_outs))
        del single_outs
        prep_ms, _ = timed_frames(preps[name], range(BATCH))
        covf_gpu = float(st["covered_fraction"][-1])
        say("serve_batch", path=name, frames=BATCH, batches=BATCHES,
            size=f"{W}x{H}", msaa=4, shadow=SHADOW,
            median_ms=f"{med:.4f}", min_ms=f"{min(batch_ms):.4f}",
            max_ms=f"{max(batch_ms):.4f}",
            per_frame_ms=f"{med / BATCH:.4f}",
            mpix_s=f"{BATCH * W * H / med / 1e3:.3f}", card=repr(smi))
        say("serve_batch", path=name, split="median ms per frame",
            batch=f"{med / BATCH:.4f}",
            prep=f"{statistics.median(prep_ms):.4f}",
            render_frame_loop=f"{statistics.median(single_ms):.4f}",
            card=repr(smi))
        say("serve_batch", path=name, launches=json.dumps(launches),
            finite=finite, shapes_ok=shapes_ok,
            frames_equal_render_frame=frames_eq,
            covered_fraction_gpu=covf_gpu,
            covered_fraction_cpu=covf_cpu_last[name])
        want = {k: 0 for k in launches}
        want.update({k: n * BATCHES for k, n in want_batch[name].items()})
        if launches != want:
            fail(f"{name} batch launch counts {launches} != {want}")
        if not (finite and shapes_ok and frames_eq):
            fail(f"{name} batch frames non-finite, misshapen or unequal to "
                 "render_frame")
        if not abs(covf_gpu - covf_cpu_last[name]) <= 1e-6:
            fail(f"{name} batch covered_fraction {covf_gpu} (GPU) vs "
                 f"{covf_cpu_last[name]} (CPU)")
        for k, n in launches.items():
            path_launches[k] += n
        del rgba, st
    hoisted()                                         # warm-up
    hoisted_ms, outs = timed_frames(lambda _: hoisted(), range(BATCHES))
    hoisted_eq = torch.equal(outs[-1][0], batch_flagship()[0])
    del outs
    med = statistics.median(hoisted_ms)
    say("serve_batch", path="flagship_hoisted", frames=BATCH,
        batches=BATCHES, median_ms=f"{med:.4f}",
        per_frame_ms=f"{med / BATCH:.4f}",
        mpix_s=f"{BATCH * W * H / med / 1e3:.3f}",
        frames_equal_fused_batch=hoisted_eq, card=repr(smi))
    if not hoisted_eq:
        fail("the hoisted batch's frames differ from the fused batch's")

    # 17. profile one batch of each branch -----------------------------------
    for name, fn in (("flagship_batch", batch_flagship),
                     ("config4_batch", batch_config4)):
        prof = profile_batch(fn, BATCH)
        say("profile", path=name, frames=BATCH, per="frame",
            **{k: f"{v:.4f}" for k, v in prof.items()}, card=repr(smi))

    meta = {"raster_depth": (RASTER_SRC, "raster_pallas.py:865"),
            "render_fused": (RASTER_SRC, "raster_pallas.py:997"),
            "raster_gbuffer": (RASTER_SRC, "raster_pallas.py:865"),
            "sample_bilinear": (SAMPLE_SRC, "sample_pallas.py:642"),
            "sample_pyramid": (SAMPLE_SRC, "mip_pallas.py:475"),
            "raster_depth_batch": (RASTER_SRC, "raster_pallas.py:1151"),
            "raster_gbuffer_batch": (RASTER_SRC, "raster_pallas.py:1207"),
            "render_fused_batch": (RASTER_SRC, "raster_pallas.py:1278"),
            "sample_bilinear_batch": (SAMPLE_SRC, "sample_pallas.py:587")}
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
