#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA GPU and check it.

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
     kernel per frame, finite frames, covered_fraction equal to the CPU run
     of the same frame within 1e-6.
Then one JSON line with each kernel's numbers, the nvidia-smi line, and the
result line {"ok": true, "device": {...}}.

Tolerances: K1 runs the twin's exact operation sequence (anchored planes,
every multiply and add rounded on its own: nvcc -fmad=false, eager torch
ops), so its output is bit-equal. K2's shading adds sqrtf, IEEE division
and powf: sqrt and division are correctly rounded on both sides, and powf
is the same libdevice routine in torch's kernel and in ours, so rgba agrees
to float32 rounding; 1e-5 leaves room for a differing libdevice version.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, SHADOW, FRAMES = 1920, 1080, 1024, 16
SOURCE = "metalrenderer_tpu_torch/csrc/raster.cu"


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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app
    from metalrenderer_tpu_torch.io import png
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import _build, binning, raster_cuda
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight

    dev = torch.device("cuda:0")
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
    say("k1", shape=f"{SHADOW}x{SHADOW}x1", ms=f"{k1_ms:.4f}",
        plain_ms=f"{k1_plain_ms:.4f}", card=repr(smi))

    # 3. K2 against its twin ------------------------------------------------
    shadow_map = raster_cuda.raster_depth(sb, SHADOW, SHADOW, center)[0][0]
    samples = tuple(cfg.sample_positions)
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
    say("k2", ms=f"{k2_ms:.4f}", plain_ms=f"{k2_plain_ms:.4f}", card=repr(smi))

    # 4. golden --------------------------------------------------------------
    gcfg = RenderConfig(width=800, height=600, msaa=4, shadow_map_size=1024)
    gcam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=800 / 600)
    fb, _ = audio_app.render_audio_app(camera=gcam, config=gcfg, device=dev)
    golden = png.read_png(ROOT / "tests" / "goldens" / "audio_app_800x600.png")
    a = np.clip(fb.cpu().numpy()[..., :3], 0, 1)
    b = golden.astype(np.float32) / 255.0
    psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    say("golden", size="800x600", psnr_db=f"{psnr:.3f}", bar=40)
    if not psnr >= 40.0:
        fail(f"golden PSNR {psnr:.3f} dB < 40")

    # 5. serve ---------------------------------------------------------------
    disps = [float(d) for d in np.linspace(0.0, 0.05, FRAMES)]

    def frame(d):
        return audio_app.render_audio_app(displacement=d, camera=cam,
                                          config=cfg, device=dev, scene=scene)

    frame(disps[0])                                   # warm-up
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    frame_ms, outs = [], []
    for d in disps:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        outs.append(frame(d))
        e.record()
        e.synchronize()
        frame_ms.append(s.elapsed_time(e))
    launches = dict(raster_cuda.LAUNCHES)
    prep_ms = []
    for d in disps:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        pipeline.prepare_frame(scene, cam, lighting, cfg, displacement=d,
                               shadow_target=(0.0, 0.0, -1.0), device=dev)
        e.record()
        e.synchronize()
        prep_ms.append(s.elapsed_time(e))
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
    if launches != {"raster_depth": FRAMES, "render_fused": FRAMES}:
        fail(f"launch counts {launches} != one per kernel per frame")
    if not (finite and shapes_ok):
        fail("non-finite or misshapen frames")
    if not abs(covf_gpu - covf_cpu) <= 1e-6:
        fail(f"covered_fraction {covf_gpu} (GPU) vs {covf_cpu} (CPU)")

    kernels = [
        {"name": "raster_depth", "route": "cuda", "source": SOURCE,
         "replaces": "metalrenderer_tpu/raster/raster_pallas.py:865",
         "launches": launches["raster_depth"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "render_fused", "route": "cuda", "source": SOURCE,
         "replaces": "metalrenderer_tpu/raster/raster_pallas.py:997",
         "launches": launches["render_fused"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
