#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (one line each; any failure exits non-zero and prints no result):
  0. environment: the card's name and power limit, torch/CUDA/nvcc versions;
  1. build the kernels from metalrenderer_tpu_torch/csrc with nvcc: per
     kernel its registers, shared memory and spills (-Xptxas -v) and its
     SASS instruction count (cuobjdump -sass, where the toolkit has it);
  2. K1 raster_depth against its plain twin on the card, with and without
     the winner plane: the flagship shadow pass (1024^2, the port's own
     prep), a seeded soup of 4,000 triangles at 1024^2, and crowded soups
     (fused_soup_bins: a tile list longer than a staging chunk) at 1024^2
     on 64x128 tiles with a big list near its cap and at 1000x601 on 40x24
     tiles, there also with 4 samples — winners equal, depth bit-equal;
     timed in the shadow path's depth-only form, the winner-carrying form
     beside it;
  3. K2 render_fused against its plain twin on the flagship main pass
     (1920x1080, 4x MSAA) and on seeded soups with attribute tables
     (fused_soup_bins: tile lists, one tile's candidates outgrowing the
     kernel's staging chunk, a big list near its cap, z-fighting coplanar
     pairs) at 1920x1080 and at the ragged 1000x601 on 8x128 tiles, and at
     1000x601 on 40x24 tiles, and on a 1920x1080 soup whose centre tile
     holds ~12,000 candidates (crowd=10000: the split walk, its items
     merged per sample; the split line: split tiles, items, scratch, and
     the item count the device scheduled, equal to the host's) — covered
     fractions equal, rgba within 1e-5;
  4. an 800x600 flagship frame against tests/goldens/audio_app_800x600.png,
     >= 40 dB PSNR;
  5. serve 16 flagship frames (1920x1080 MSAA4, 1024^2 shadow map,
     displacement linspace(0, 0.05)) through render_audio_app(device="cuda"):
     median ms/frame and Mpixel/s, the prep/kernel split, one launch of each
     fused-path kernel per frame, finite frames, covered_fraction equal to
     the CPU run of the same frame within 1e-6;
  6. K3 raster_gbuffer against its twin on BASELINE config 4's main pass
     (1920x1080 MSAA4, the port's own prep) — per-sample winners equal,
     depth and gout bit-equal — and on phase 3's soups (1920x1080 and
     1000x601 on 8x128 tiles, 1000x601 on 40x24 tiles with the per-sample
     depth and winner planes, the crowd10k soup with them) — gout (and
     depth, winner) bit-equal;
  7. K7 sample_bilinear against its twin on that frame's shadow lookup
     (its 1024^2 shadow map) — max abs error 0 — and, bit-equal, on the
     same planes with no pixel sampled (timed: the launch's fixed cost,
     beside its bound) and on views of them that start 4, 8 and 12 bytes
     past a 16-byte boundary (out of phase with the output: the kernel's
     scalar path); K7's ptxas line; beside it, the time of one
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
     seen from theta 2.2, near-clips heavily) and on a 2-frame batch of
     phase 2's two crowded 1024^2 soups, with and without the winner plane
     — winners equal, depth bit-equal, and bit-equal to K1 launches on the
     same bins; timed as K1 is;
 13. K6 render_fused_batch against its twin on that batch's main passes
     (1920x1080 MSAA4, K4's shadow maps), on a 2-frame batch of two such
     soups and on a 2-frame batch of two crowd10k soups — covered
     fractions equal, rgba within 1e-5, and bit-equal to per-frame K2
     launches;
 14. K5 raster_gbuffer_batch against its twin on 8 config-4 frames (the
     camera orbiting by 0.01 rad a frame) and on phase 13's two 2-frame
     batches of soups — gout bit-equal, and bit-equal to per-frame K3
     launches;
 15. K8 sample_bilinear_batch against its twin on those frames' shadow
     lookups (their own 1024^2 maps) — max abs error 0, and bit-equal to
     eight K7 launches — and on those lookups cut to 1919x1079 a frame
     (an odd H*W: each frame's planes start at another vector phase),
     bit-equal to the twin and to K7; beside it, the time of one
     grid_sample call on the eight padded maps at the eight frames'
     coordinates (as in phase 7);
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
 18. K3s raster_gbuffer_samples against its twin on the flagship main pass
     (1920x1080 MSAA4, 8x128 tiles) and on config 4's main pass binned on
     16x128 tiles — per-sample winners equal, depth and gout (f32
     [4,16,1080,1920], 531 MB) bit-equal;
 19. serve 8 flagship frames with shading_per_pixel=False (supersampled
     shading) through render_frame(device="cuda"): median/min/max ms, the
     prep/kernel split, per frame one K1, one K3s, one K7 and no K2/K3
     launch, finite frames, covered_fraction equal to the CPU run of the
     last frame within 1e-6 and its rgba within 2e-4 of it; K9 against its
     twin on config 4's [4,1080,1920] sample planes (bit-equal); then one
     config-4 frame with shading_per_pixel=False (K9 on those planes, one
     launch per pass) and one with tile_h=16 (the fragment of the first
     covered sample) against their CPU runs (covered_fraction within 1e-6,
     rgba within 2e-4); peak device memory of each;
 20. the audio track's carries kernels (audio/track_cuda.py, kernel
     csrc/track.cu) at 1, 8 and 32 chunks a call from seeded states, the
     rolling window empty, filling, full and wrapping: new state, carried
     values and envelope bit-equal to the numpy twins, one launch of each
     a call; at 1 and 8 chunks each kernel's ms, device ms, its twin's
     host ms and its bound. Then the audio-reactive sequence: 32 chunks of
     audio synthesized with numpy from a seed (stepped tones 110/220/440/880 Hz, a noise burst, silence;
     48 kHz) through render_audio_reactive_sequence(device="cuda") at full
     width: the track's VisualParams against the CPU run (its graph
     captured at the second call and replayed: no carries launch in the
     sequence), the frames
     through the fused batch (one K4 and one K6 for the sequence, no
     per-frame kernel), ms per frame and Mpixel/s, the track's ms apart
     from the render's; the same samples through
     stream_audio_reactive(chunk_frames=16): the concatenation against the
     offline frames, the track op by op then captured (three launches of
     each carries kernel); 8 chunks with shading_per_pixel=False: the per-frame
     branch (one K1 + K3s + K7 per frame), each frame equal to
     render_frame of the same parameters; and a 96x72 sequence of 6 chunks
     on the card against the CPU run.
 21. BASELINE configs 2, 3 and 5 at full size, built by the port's own
     engine/configs.py on the card: config 2 (24 cubes and UV spheres,
     1920x1080 MSAA4, no shadow map), config 3 (a 100k-triangle sphere
     written to an OBJ file and loaded back by the native parser, which
     must build; a 512^2 checkerboard; 1920x1080, one sample) and config 5
     (1M triangles, 3840x2160, one sample). Per config: triangles, slots,
     list entries, the big list (no triangle dropped), tiles with a list,
     the longest list, the most candidates of a tile against the staging
     chunk; then on the config's own bins K2 with no shadow map at 4
     samples (config 2) and at 1 (config 5) — covered fractions equal, rgba
     within 1e-5 —, K3 at 1 sample (config 3) — gout, depth and winners
     bit-equal —, K9 on config 3's color lookup — bit-equal —, and K6 on a
     2-frame config-5 batch — within 1e-5 of its twin and bit-equal to
     render_frame; each timed beside its bound, K2 and K3 also on the
     same bins with every list emptied but the longest (what one tile's
     walk costs) and with none (the fixed cost), beside the times of
     the one-block walk that came before the split walk, and the split
     line of each (split tiles, items,
     scratch bytes, the device's item count). Then 8 frames each of
     configs 2 and 3 (the camera orbiting by 0.01 rad a frame) and 4
     config-5 frames (displacement linspace(0, 0.05)) through
     render_frame(device="cuda"): median/min/max ms, the prep alone, peak
     device memory, torch.profiler over 4 (config 5: 2) frames, the launch
     counts (config 2: one K2 a frame; config 3: one K3 and two K9, the
     normal-map pass's with nothing to sample; config 5: one K2), finite
     frames, covered_fraction equal to the CPU run of the last frame within
     1e-6 (config 5 at 960x540 with 100k triangles, the card's frame of
     that size) and the rgba difference; one render_batch of 2 config-5
     frames: one K6, frames bit-equal to render_frame's.
 22. the app layer at 1920x1080, 4xMSAA, 1024^2 shadow map, through
     metalrenderer_tpu_torch.cli.main(argv) in process (stdout captured,
     files in a temporary directory) and one ``python -m
     metalrenderer_tpu_torch.cli render`` subprocess, which must exit 0 and
     write the same PNG: render (one frame: rgba bit-equal to
     render_audio_app, one K1 + K2; --frames 8 --orbit 0.8: one K4 + K6,
     frames bit-equal to render_batch and to render_frame at each theta;
     PNG ms per frame), flythrough (three key poses, 8 frames a segment:
     17 PoseCameras in one K4 + K6 batch, each frame within 1e-5 of
     render_frame at its slerped pose; the render's ms per frame apart from
     the CLI's wall time with PNG writes, peak device memory), session (a
     40-event script, session_script: 47 frames, one K1 + K2 each, resize
     to 1280x720 and back, scroll to the minimum radius; event-to-frame
     latency on the host, median/min/max, beside phase 5's median; the CLI
     run equal to the in-process one; 4 frames traced with
     utils.profiling.device_trace: launch calls and device-busy ms per
     frame, the trace must name raster_depth_kernel and
     render_fused_kernel; the script at 160x120 on the card and on the
     CPU: camera states equal after every event, last frames within
     1e-5), audioapp (phase 20's signal as a 16-bit WAV: offline frames
     and telemetry bit-equal to render_audio_reactive_sequence, one K4 +
     K6; --stream --chunk-frames 16 within 1e-5 of the offline frames,
     fetch_ms per chunk), a stream resumed at chunk 16 from the analyzer
     and visual states saved and restored by utils.checkpoint (bit-equal
     to the unbroken stream), and analyze --dashboard (32 dashboards; the
     JSON lines within 1e-5 relative of the CPU run's, |b| floored at 0.1,
     the melancholy within 1e-4);
 23. the brute-force reference backend (backend="reference", no raster
     kernel launched): the flagship at 1920x1080 MSAA4 with a 1024^2 map, config
     4, config 3 at one sample and the 800x600 flagship, each against the
     kernels' frame (>= 40 dB; PSNR, max abs diff, covered fractions, the
     reference's ms), the 800x600 one also against its golden (>= 40 dB);
     K3s's winner plane against the brute force's winners (anchored at the
     main-pass tiles) on the same setup for config 3 (1080p), config 5
     (3840x2160) and the flagship: the differing samples and how many are
     z-fights (both triangles cover the sample at depths within 2 ulp),
     any other difference fails; K3's per-sample winners (the split walk)
     on configs 3 and 5 likewise, held to 0 differing samples; at 160x120
     every entry point on the
     reference backend (render, render_batch, the session, the camera
     path, the sequence, the CLI; frames equal to render_frame's) and the
     reference frame on the card within 1e-5 of the CPU's;
 24. multi-device rendering (parallel/sharding.py) on the one card: a
     world-size-1 NCCL group (file store), render_frame_batch of 8
     flagship frames (one K4 + one K6, bit-equal to render_batch) and
     render_tile_sharded (bit-equal to render_frame); then the flagship
     in 2 and 4 bands and config 3 in 4, band by band through
     sharding.prepare_band and the frame's render: per band its in-band
     triangles, drops, prep and render ms beside the unsharded frame's,
     config 3's longest tile list; per band, every kernel call replayed
     through its twin (at the bars above), the reference backend's band on
     the same setup (>= 40 dB) and K3s's winners against the brute force's
     (z-fights only); the assembled frame's pixels beyond 1e-4 of the
     unsharded one, for the kernels and for the reference backend
     (printed, not held: the JAX package's bands differ
     from its unsharded frame likewise, tests/torch_band_witness.py), its
     PSNR (>= 40 dB) and the samples K3s covers otherwise than on the
     unsharded frame (<= BAND_FLIPS of them).
 25. the prep graph (prep.PREP_GRAPH, on the card the frame's prep
     captured as a CUDA graph at its shape's second frame and replayed)
     against the prep run op by op: the flagship frame, config 4 (the split
     path) and config 5 (1M triangles, 3840x2160), each from an empty
     cache and replayed at a second displacement and camera, and an
     8-frame AudioApp batch through render_frame_batch_fused with eight
     displacements and light colors: tables, stacked tables and frames
     bit-equal; per case the prep's host ms, launch calls and device-busy
     ms, op by op and graphed, the graph's device ms (its replays back to
     back), the first frame's and the capture's ms, reserved memory (the
     graph's pool) and peak; then a one-off render_frame of a new shape
     and a session resized every frame through six sizes (frame ms,
     captures).
 26. BASELINE config 5 at full size (1M triangles, 3840x2160, one sample)
     over a sweep of displacements (SWEEP_DISPLACEMENTS: the one at which
     K2<1> and K6<1> once shaded a pixel ~448x too bright, and SWEEP_N
     more over [0, 0.05]) through render_frame and render_batch (two
     frames a call), every frame held against the reference backend's by
     the benchmark's numbers: frame_mae (mean |rgba - reference|) within
     SWEEP_FRAME_MAE and tile_mae (the largest such mean over an 8x8-pixel
     tile) within SWEEP_TILE_MAE, the sphere cells' limits; the largest
     reading of each path; first, at that displacement, pixel (1879, 378):
     the winner's tid, its screen vertices, area and 1/w, the 1/w plane
     evaluated there, the bounded weights' 1/w, and both frames' rgba.
 27. the main pass's geometry front end (raster/setup_cuda.py, kernel
     csrc/setup.cu) on config 5 at full size and the flagship frame: the
     op-by-op prep's device ms by mr/prep/* span, the prep graph's device
     ms a frame and its pool; the kernel's tables and stats against the
     plain chain's (bit-equal), its device ms host ahead with the guard
     band off (the tables pass alone) and on, beside its byte bound and
     the plain chain's ms; its launch counter.
Then the run's seconds, one JSON line with each kernel's numbers (and a row
for each of phase 21's cases, ``name<samples>@config``), the nvidia-smi
line, and the result line {"ok": true, "device": {...}}.

Every kernel, and each grid_sample yardstick, is timed two ways over many
launches: back to back with CUDA events (``ms``; below ~0.06 ms a launch
the Python wrapper's host cost paces it) and with the host ahead
(``device_ms``: the launches queued behind a spinning kernel, so they run
back to back on the device whatever the host costs).

Tolerances: K1 and K3 run their twins' exact operation sequence (anchored
planes, every multiply and add rounded on its own: nvcc -fmad=false, eager
torch ops), and so do K7 and K9 (the reference sampler's coordinate and
lerp expressions), so their outputs are bit-equal. K2's shading adds
sqrtf, IEEE division and powf: sqrt and division are correctly rounded on
both sides, and powf is the same libdevice routine in torch's kernel and
in ours, so rgba agrees to float32 rounding; 1e-5 leaves room for a
differing libdevice version. The split walk of K2, K3, K5 and K6
(a long tile's candidates in items over blocks) merges each sample's
items' winners into their lexicographic minimum of (z, -tid), the
winner's own depth bits kept, which is the one-block walk's result: the
bars stay. K4, K5, K6 and K8 run the per-frame kernels'
code on each frame's slice of the stacked tables, so each batch frame is
bit-equal to the per-frame launch, K4, K5 and K8 bit-equal to their twins
(the per-frame twins frame by frame) and K6 within K2's 1e-5 of its
twin. K3s runs its twin's operation sequence (K1's visibility, then
(a*sx + b*sy) + c per covered sample, every step rounded on its own), so
it is bit-equal. The audio track on the card against the CPU: cuFFT and
the CPU FFT round differently (~1e-7 of a chunk's peak), the per-chunk
sums and the prefix sum are taken in another order, and the carries are
float32 in chunk order either way (kernels bit-equal to the CPU's numpy
loops): light intensity and displacement within
1e-5 relative; the light color within 5e-5 absolute (its hue takes 0.08 of
the melancholy, whose minor/major-third ratio sums bins that for a pure
tone hold only window leakage at 1e-5 of the peak, and one ulp of log2,
and multiplies both by 6 in the hue's sector fraction). The stream's
frames against the offline ones: cuFFT may round a [16, 1024] batch and a
[32, 1024] batch differently, so <= 1e-5 is required and the largest
difference reported. CPU against GPU frames: the prep is device-independent,
but the split path's LOD takes a log2 that CPU and GPU may round one ulp
apart, which moves a trilinear blend weight by ~1e-7: covered fractions
must be equal (1e-6), the rgba difference is reported. On the per-sample
branch (phases 19 and 20) the card's frames must also lie within 2e-4 of
the CPU run's: powf and log2 differ by an ulp between the two, which the
specular term and the box resolve carry to ~1e-5 of a channel, while a
fault in K3s, K7 or K9 on the [S, H, W] planes moves a pixel by 1e-2 or
more.

Bounds (bound_ms): the larger of the bytes a launch must move (each input
tensor read once, each output written once) over 3.35 TB/s and its FP32
operations over 67 TFLOP/s (the H100 SXM's published rates at 700 W). The
raster kernels' operations are counted from this run's bins: 16 per
(candidate triangle, sample) — four plane evaluations of two multiplies
and two adds — plus 105 per covered pixel for the 15 attributes (K2,
K3: the winner's three edge values at 8 each, their sum, a division and
three multiplies for the weights, then 5 a group), 105 per covered sample
(K3s, whose bytes are 64 per sample of
gout plus the per-sample depth and winner planes); the samplers' per
sampled pixel: 18 (K7), 94 (K9). The samplers read u, v (and K9 its
LOD) only where the mask is set, so their bytes count 8 (K7, K8) or 12
(K9) per sampled pixel, plus the whole texture, mask and output (K7 with
no pixel sampled: mask and output). K1 and K4 write 4 B of depth a
sample, 8 B with the winner plane: each form has its own bound. A batch
kernel's bound counts every frame's bytes and operations (K4, K5, K6 as
K1, K3, K2 summed over the frames; K8 as K7).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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
TRACK_SRC = "metalrenderer_tpu_torch/csrc/track.cu"
HBM_BYTES_PER_MS = 3.35e9     # 3.35 TB/s
FP32_OPS_PER_MS = 67e9        # 67 TFLOP/s outside the tensor cores
# A covered pixel's (or sample's) 15 attributes: its winner's weights (3 x
# 8 for the edge values, 2 adds, 1 division, 3 multiplies), 5 a group.
ATTR_OPS = 3 * 8 + 2 + 1 + 3 + 15 * 5
SS_RGBA_TOL = 2e-4            # card vs CPU frames of the per-sample branch
# Phase 21, BASELINE configs 2, 3 and 5 at full size: 24 objects and 100k
# triangles at CW x CH, 1M at C5_W x C5_H; served CFG_FRAMES (2, 3) and
# C5_FRAMES (5) frames; config 5's CPU comparison at C5_CPU (w, h, triangles).
C2_OBJECTS, C3_TRIS, C5_TRIS = 24, 100_000, 1_000_000
CW, CH, C5_W, C5_H = 1920, 1080, 3840, 2160
CFG_FRAMES, C5_FRAMES = 8, 4
C5_CPU = (960, 540, 100_000)
# Phase 26: config 5's sweep. The displacement of the sliver fault (K2<1>
# and K6<1> evaluated a pole triangle's attribute planes at pixel (1879,
# 378); ROADMAP C13), SWEEP_N more over [0, 0.05], and the sphere cells'
# limits.
SWEEP_FAULT, SWEEP_PIXEL = 0.040847379714250565, (1879, 378)
SWEEP_N = 199
SWEEP_FRAME_MAE, SWEEP_TILE_MAE, SWEEP_TILE = 5e-5, 0.025, 8
# Phase 24: the share of an assembled frame's samples that its bands may
# cover otherwise than the unsharded frame, by K3s's winners (rounding at
# edges and cracks).
BAND_FLIPS = 1e-4


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


# A mangled kernel's template arguments: the sample count and, for the
# tile kernels of the split walk, whether the instance is the split kernel.
_TEMPLATE_ARGS = r"(?:ILi(\d+)E(?:Lb([01])E)?E)?"


def kernel_name(m):
    """``name<NS>`` or ``name<NS,split>`` from a match of _TEMPLATE_ARGS."""
    if not m[2]:
        return m[1]
    return m[1] + (f"<{m[2]},split>" if m[3] == "1" else
                   f"<{m[2]}>")


def ptxas_summary(log):
    """Per kernel of an ``nvcc -Xptxas -v`` build log: {name: "R regs,
    B B smem, spills S/L B"} (``name<N>`` for a template instance)."""
    out, name, spill = {}, None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?([a-z][a-z_]*_kernel)"
                      + _TEMPLATE_ARGS, ln)
        if m:
            name = kernel_name(m)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m[1]}/{m[2]}"
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = (f"{m[1]} regs, {smem[1] if smem else 0} B smem, "
                         f"spills {spill} B")
            name, spill = None, "?"
    return out


def sass_counts(lib):
    """SASS instructions per kernel in the shared library ``lib``, from
    ``cuobjdump -sass`` where the toolkit has it ({} where not)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = run([tool, "-sass", str(lib)])
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*?([a-z][a-z_]*_kernel)" + _TEMPLATE_ARGS,
                      ln)
        if m:
            name = kernel_name(m)
            out[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            out[name] += 1
    return out


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
        fail("device_ms: the spin ended before the launches were queued")
    end.synchronize()
    return start.elapsed_time(end) / reps


def timings(fn, reps):
    """(cuda_ms, device_ms) of fn() over reps launches: back to back, and
    with the host ahead."""
    return cuda_ms(fn, reps), device_ms(fn, reps)


def timed_once(fn):
    """fn() once, timed with CUDA events: (output, ms). For the twins whose
    one call takes seconds on real lists."""
    ms, outs = timed_frames(lambda _: fn(), [None])
    return outs[0], ms[0]


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
    (candidate, sample) of every pixel, ATTR_OPS per covered pixel."""
    import torch
    tiles = torch.arange(bins.ntx * bins.nty, device=bins.vis.device)
    cand = candidate_counts(bins)
    x0 = (tiles % bins.ntx) * bins.tile_w
    y0 = (tiles // bins.ntx) * bins.tile_h
    npx = (torch.clamp(width - x0, max=bins.tile_w)
           * torch.clamp(height - y0, max=bins.tile_h))
    return (16 * n_samples * int((cand * npx).sum())
            + ATTR_OPS * int(covered_px))


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


def psnr_frames(a, b):
    """PSNR of two float frames on any device, every channel clipped to
    [0, 1]."""
    d = a.clamp(0, 1).float() - b.to(a.device).clamp(0, 1).float()
    return 10 * math.log10(1.0 / max(float((d * d).mean()), 1e-12))


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


def fused_soup_bins(width, height, seed, device, crowd=400, small=1200,
                    big=240, tile_w=128, tile_h=8, big_extent=150.0):
    """A seeded main-pass soup with attribute tables, binned for K2 on
    ``tile_w`` x ``tile_h`` tiles (span cap 8, big-list cap 256):
    ``crowd`` triangles of a few pixels inside the tile at the image's
    center, whose list outgrows one staging chunk; ``small`` such triangles
    anywhere (the tile lists); ``big`` of half extent 0.3-1 x
    ``big_extent`` pixels and at least 80 rows (the big list: on 8x128
    tiles the default reaches it; 64x128 tiles need ~500).
    One triangle in four gets a partner in its plane: an exact duplicate
    (ties go to the larger tid) or, every other time, a triangle made of
    affine combinations of its clip-space vertices, whose depth planes
    differ from the original's by rounding (z-fighting). Materials mix
    Blinn-Phong, shadow-receiving and emissive. Returns TileBins."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch.passes.pipeline import PassGeometry
    from metalrenderer_tpu_torch.raster import binning
    from metalrenderer_tpu_torch.raster.geometry import setup_triangles
    rng = np.random.default_rng(seed)
    cx = (width // 2 // tile_w) * tile_w
    cy = (height // 2 // tile_h) * tile_h
    groups = [  # (count, center box x0, y0, x1, y1, half extent x, y)
        (crowd, cx, cy, cx + tile_w, cy + tile_h, 10.0, 3.0),
        (small, 0, 0, width, height, 20.0, 3.0),
        (big, 0, 0, width, height, big_extent, big_extent)]
    tris = []
    for n, x0, y0, x1, y1, hx, hy in groups:
        c = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)
        ext = rng.uniform(0.3, 1.0, (n, 1, 2)) * np.array([hx, hy])
        if n and hy > 100:      # big: at least 80 rows, >8 tiles of 8x128
            ext[:, :, 1] = np.maximum(ext[:, :, 1], 40.0)
        pts = c[:, None] + ext * rng.uniform(-1.0, 1.0, (n, 3, 2))
        tris.append(pts)
    pts = np.concatenate(tris)                                # [n, 3, 2] px
    n = pts.shape[0]
    ndc = np.stack([pts[..., 0] * (2.0 / width) - 1.0,
                    1.0 - pts[..., 1] * (2.0 / height)], -1)
    z = rng.uniform(0.02, 0.98, (n, 1)) + rng.uniform(-0.02, 0.02, (n, 3))
    w = rng.uniform(0.5, 3.0, (n, 1)) * rng.uniform(0.9, 1.1, (n, 3))
    clip = np.concatenate([ndc * w[..., None], (z * w)[..., None],
                           w[..., None]], -1)                 # [n, 3, 4]
    pick = np.arange(0, n, 4)
    mix = np.array([[0.7, 0.2, 0.1], [0.1, 1.1, -0.2], [0.2, -0.1, 0.9]])
    partner = clip[pick].copy()
    partner[1::2] = np.einsum("ij,njk->nik", mix, clip[pick[1::2]])
    clip = np.concatenate([clip, partner]).astype(np.float32)
    t = clip.shape[0]
    world = rng.uniform(-1.5, 1.5, (t, 3, 3))
    world[..., 1] = np.abs(world[..., 1]) * 0.3 - 0.2
    normal = rng.normal(size=(t, 1, 3)) + 0.2 * rng.normal(size=(t, 3, 3))
    normal[..., 1] = np.abs(normal[..., 1]) + 0.5
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    vattrs = np.concatenate([world, rng.uniform(0, 1, (t, 3, 2)), normal], -1)

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    kind = rng.choice([0, 1, 2], t, p=[0.3, 0.6, 0.1])
    none = torch.full((t,), -1, dtype=torch.int32, device=device)
    pg = PassGeometry(vattrs=f32(vattrs),
                      mat_kind=torch.from_numpy(kind.astype(np.int32)).to(device),
                      mat_color=f32(rng.uniform(0.2, 1.0, (t, 3))),
                      tex_id=none, normal_map_id=none)
    setup = setup_triangles(f32(clip), width, height, cull_backfaces=False)
    return binning.bin_triangles(setup, binning.build_tri_fields(setup),
                                 width, height, tile_w, tile_h,
                                 attr_fields=binning.build_attr_fields(setup,
                                                                       pg))


def candidate_counts(bins):
    """Candidates per tile (``raster_cuda._candidates``: the tile's list and
    the gated big list, valid or not), i64[NT]."""
    import torch
    from metalrenderer_tpu_torch.raster import raster_cuda
    tiles = torch.arange(bins.ntx * bins.nty, device=bins.vis.device)
    return (raster_cuda._candidates(bins, tiles) >= 0).sum(dim=1)


def audio_signal(chunks, seed, sample_rate=48000.0):
    """``chunks`` x 1024 samples, f32 numpy, from a seed: stepped tones
    110/220/440/880 Hz (random phases), a noise burst, silence, in six
    equal parts."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = chunks * 1024 // 6
    t = np.arange(n) / sample_rate
    parts = [0.4 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
             for f in (110.0, 220.0, 440.0, 880.0)]
    parts.append(0.3 * rng.standard_normal(n))
    parts.append(np.zeros(chunks * 1024 - 5 * n))
    return np.concatenate(parts).astype(np.float32)


def peak_mb(fn):
    """fn() and the peak device memory it reached, in MB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e6


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
    from metalrenderer_tpu_torch.audio import track_cuda
    from metalrenderer_tpu_torch.raster import mip_cuda, raster_cuda, sample_cuda
    for mod in (raster_cuda, sample_cuda, mip_cuda, track_cuda):
        mod.reset_launch_counts()


def read_counts():
    from metalrenderer_tpu_torch.audio import track_cuda
    from metalrenderer_tpu_torch.raster import mip_cuda, raster_cuda, sample_cuda
    return {**raster_cuda.LAUNCHES, **sample_cuda.LAUNCHES,
            **mip_cuda.LAUNCHES, **track_cuda.LAUNCHES}


def kernel_row(name, source, replaces, launches, err, ms, dev_ms, plain_ms,
               bound_ms_by, lib_ms=None, lib_dev=None):
    """One entry of the final ``kernels`` line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"metalrenderer_tpu/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
            "library_ms": lib_ms, "library_device_ms": lib_dev}


def list_stats(name, prep):
    """Print a main pass's tile lists (triangles, slots after clipping,
    list entries, big list, tiles with a list, the longest list and the
    most candidates of a tile against the staging chunk) and fail on a
    dropped big-list triangle; returns them."""
    from metalrenderer_tpu_torch.raster import raster_cuda
    mb = prep.main_bins
    cnt = candidate_counts(mb)
    per_tile = mb.tile_offsets[1:] - mb.tile_offsets[:-1]
    chunk = raster_cuda.FUSED_STAGING_CHUNK
    info = dict(triangles=int(prep.stats["num_triangles"]),
                slots=mb.vis.shape[0],
                culled=int(prep.stats["culled_triangles"]),
                list_entries=int(mb.tile_offsets[-1]),
                big_n=int(mb.big_n[0]), big_cap=mb.big_ids.shape[0],
                big_dropped=int(mb.num_big_dropped),
                tiles=mb.ntx * mb.nty,
                tiles_with_list=int((per_tile > 0).sum()),
                max_list=int(per_tile.max()),
                max_candidates=int(cnt.max()), staging_chunk=chunk,
                tiles_over_chunk=int((cnt > chunk).sum()))
    say("configs", config=name, **info)
    # The JAX binning drops big-list triangles past the cap by the same
    # rule; at these sizes it drops none (the port's CPU prep: 0 in each).
    if info["big_dropped"]:
        fail(f"{name}: {info['big_dropped']} big-list triangles dropped")
    return info


def longest_list_bins(bins):
    """``bins`` with every tile list emptied but the longest and no big
    list, and with every list emptied: (longest, empty, its length)."""
    import torch
    off = bins.tile_offsets.to(torch.int64)
    per = off[1:] - off[:-1]
    i = int(torch.argmax(per))
    n = int(per[i])
    idx = torch.arange(off.numel(), device=off.device)
    no_big = torch.zeros_like(bins.big_n)
    longest = dataclasses.replace(
        bins, tile_offsets=torch.where(idx <= i, 0, n).to(torch.int32),
        tile_tris=bins.tile_tris[int(off[i]):int(off[i]) + n].contiguous(),
        big_n=no_big)
    empty = dataclasses.replace(bins, tile_offsets=torch.zeros_like(
        bins.tile_offsets), big_n=no_big)
    return longest, empty, n


# tile_walk_split's three host-ahead times with every tile walked by one
# 256-thread block, before the split walk: phase 21's cases on NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 5).
ONE_BLOCK_WALK = {"k2_config2": (0.10766, 0.07529, 0.01905),
                 "k3_config3": (0.83847, 0.82866, 0.04583),
                 "k2_config5_4k": (3.21940, 2.58534, 0.05407)}


def tile_walk_split(name, bins, launch):
    """How much of a tile kernel's time one tile's list sets: host-ahead ms
    of ``launch(bins)`` on the bins, on the bins with every list emptied but
    the longest (and no big list: that tile's walk, plus the empty tiles),
    and with every list emptied (the fixed cost); the one-block walk's
    beside them."""
    longest, empty, n = longest_list_bins(bins)
    _, full_ms = timings(lambda: launch(bins), 20)
    _, longest_ms = timings(lambda: launch(longest), 20)
    _, empty_ms = timings(lambda: launch(empty), 20)
    before = ONE_BLOCK_WALK.get(name)
    say("tile_walk", case=name, longest_list=n, device_ms=f"{full_ms:.5f}",
        longest_tile_only_device_ms=f"{longest_ms:.5f}",
        no_list_device_ms=f"{empty_ms:.5f}",
        one_block_walk_device_ms="/".join(map(str, before)) if before
        else None)


def split_line(name, bins, n_samples, launch):
    """Print what the split walk does on ``bins``: split tiles, items, the
    longest tile's items, the merge keys they use and the scratch the plan
    allocates (host counts, ``raster_cuda.split_stats``), and the item count
    the device's schedule wrote after ``launch()``, which must agree."""
    import torch
    from metalrenderer_tpu_torch.raster import raster_cuda
    st = raster_cuda.split_stats(bins, n_samples)
    launch()
    torch.cuda.synchronize()
    sched = raster_cuda.scheduled_items(bins.vis.device)
    say("split", case=name, split_above=raster_cuda.TILE_SPLIT_ABOVE,
        slice_candidates=raster_cuda.TILE_SPLIT_SLICE,
        scheduled_items=sched, **st)
    if st["split_tiles"] and sched != st["items"]:
        fail(f"{name}: the device scheduled {sched} items, the lists need "
             f"{st['items']}")
    return st


def serve_config(name, frame_fn, prep_fn, args, want, smi, n_profile):
    """Serve ``frame_fn`` over ``args`` after a warm-up: per-frame ms, the
    prep alone, the launch counts (which must be ``want``), peak device
    memory of one frame and torch.profiler over ``n_profile`` frames.
    Returns (outputs, launches)."""
    import torch
    frame_fn(args[0])                                 # warm-up
    torch.cuda.synchronize()
    reset_counts()
    frame_ms, outs = timed_frames(frame_fn, args)
    launches = read_counts()
    prep_ms, _ = timed_frames(prep_fn, args)
    _, mem = peak_mb(lambda: frame_fn(args[-1]))
    med = statistics.median(frame_ms)
    w, h = outs[0][0].shape[1], outs[0][0].shape[0]
    say("serve_cfg", config=name, frames=len(args), size=f"{w}x{h}",
        median_ms=f"{med:.4f}", min_ms=f"{min(frame_ms):.4f}",
        max_ms=f"{max(frame_ms):.4f}", mpix_s=f"{w * h / med / 1e3:.3f}",
        prep_ms=f"{statistics.median(prep_ms):.4f}",
        peak_mem_mb=f"{mem:.1f}", card=repr(smi))
    prof = profile_frames(frame_fn, args[:n_profile])
    say("serve_cfg", config=name, profiled_frames=len(args[:n_profile]),
        **{k: f"{v:.4f}" for k, v in prof.items()},
        launches=json.dumps(launches))
    full = {k: 0 for k in launches}
    full.update(want)
    if launches != full:
        fail(f"{name}: launch counts {launches} != {full}")
    if not all(bool(torch.isfinite(fb).all()) for fb, _ in outs):
        fail(f"{name}: non-finite frames")
    return outs, launches


def configs_phase(dev, smi, path_launches):
    """Phase 21: BASELINE configs 2, 3 and 5 at full size on the card: the
    tile lists, the kernels against their twins on each config's own bins,
    and the frames served. Adds the serving runs' launches to
    ``path_launches``; returns the kernel rows of the new cases."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch import render_batch
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.io import native, obj
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import (binning, mip_cuda,
                                                raster_cuda, sampling, shade)
    rows = []

    def add(launches):
        for k, n in launches.items():
            path_launches[k] += n

    def orbit(cam, n):
        return [dataclasses.replace(cam, theta=cam.theta + 0.01 * i)
                for i in range(n)]

    def covf_vs_cpu(name, fb, st, fb_cpu, st_cpu, extra=None):
        gpu, cpu = float(st["covered_fraction"]), float(st_cpu["covered_fraction"])
        err = float((fb.cpu() - fb_cpu).abs().max())
        say("serve_cfg", config=name, check="card vs CPU", **(extra or {}),
            covered_fraction_gpu=gpu, covered_fraction_cpu=cpu,
            rgba_max_abs_err_vs_cpu=err)
        if not abs(gpu - cpu) <= 1e-6:
            fail(f"{name}: covered_fraction {gpu} (GPU) vs {cpu} (CPU)")

    def fused_twin(name, prep, w, h, samples):
        """K2 against its twin on one prepared frame (no shadow map)."""
        mb, uni = prep.main_bins, prep.uniforms
        r_k, c_k = raster_cuda.render_fused(mb, uni, None, w, h, samples)
        (r_p, c_p), plain_ms = timed_once(lambda: raster_cuda.render_fused_plain(
            mb, uni, None, w, h, samples))
        err = float((r_k - r_p).abs().max())
        eq = torch.equal(c_k, c_p)
        covered = int((c_k > 0).sum())
        say("k2", case=name, shape=f"{w}x{h}xS{len(samples)}",
            shadow_map=None, covered_px=covered, covf_equal=eq,
            rgba_max_abs_err=err, tol=1e-5)
        if not eq or not err <= 1e-5 or covered == 0:
            fail(f"K2 disagrees with its twin on {name} (or covered nothing)")
        ms, dev_ms = timings(lambda: raster_cuda.render_fused(
            mb, uni, None, w, h, samples), 50)
        b = bound(bins_bytes(mb, True) + nbytes(uni, r_k, c_k),
                  raster_ops(mb, w, h, len(samples), covered))
        say("k2", case=name, ms=f"{ms:.4f}", device_ms=f"{dev_ms:.5f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b[0]:.5f}",
            bound_by=b[1], card=repr(smi))
        tile_walk_split(f"k2_{name}", mb, lambda bb: raster_cuda.render_fused(
            bb, uni, None, w, h, samples))
        split_line(f"k2_{name}", mb, len(samples),
                   lambda: raster_cuda.render_fused(mb, uni, None, w, h,
                                                    samples))
        return err, ms, dev_ms, plain_ms, b

    # Config 2: 24 cubes and spheres, the fused path with no shadow map.
    scene2, cam2, light2, cfg2 = configs.config2_multi_mesh(
        n_objects=C2_OBJECTS, width=CW, height=CH, device=dev)
    prep2 = pipeline.prepare_frame(scene2, cam2, light2, cfg2, device=dev)
    if not prep2.fused or prep2.shadow_bins is not None:
        fail("config 2 did not take the fused path without a shadow map")
    list_stats("config2", prep2)
    k2c2 = fused_twin("config2", prep2, CW, CH, tuple(cfg2.sample_positions))
    cams2 = orbit(cam2, CFG_FRAMES)
    outs, launches = serve_config(
        "config2", lambda c: pipeline.render_frame(scene2, c, light2, cfg2,
                                                   device=dev),
        lambda c: pipeline.prepare_frame(scene2, c, light2, cfg2, device=dev),
        cams2, {"render_fused": CFG_FRAMES}, smi, 4)
    add(launches)
    rows.append(kernel_row("render_fused<4>@config2_no_shadow_map",
                           RASTER_SRC, "raster/raster_pallas.py:997",
                           launches["render_fused"], *k2c2))
    fb_cpu, st_cpu = pipeline.render_frame(scene2.to("cpu"), cams2[-1],
                                           light2, cfg2, device="cpu")
    covf_vs_cpu("config2", *outs[-1], fb_cpu, st_cpu)
    del prep2, outs, fb_cpu

    # Config 3: the 100k-triangle asset through the OBJ file, the split
    # path at one sample (K3 and K9).
    t0 = time.perf_counter()
    path = configs.obj_asset_path(C3_TRIS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parser = "native" if native.native_available() else "python"
    mesh3 = obj.load_obj(path)
    load_s = time.perf_counter() - t0
    say("configs", config="config3", obj=path.name,
        obj_mb=f"{path.stat().st_size / 1e6:.1f}", write_s=f"{write_s:.3f}",
        load_s=f"{load_s:.3f}", parser=parser,
        build_error=repr(native.build_error()),
        triangles=mesh3.num_triangles)
    if parser != "native":
        fail("the native OBJ parser did not build: "
             f"{native.build_error()}")
    scene3, cam3, light3, cfg3 = configs.config3_high_poly(
        target_tris=C3_TRIS, width=CW, height=CH, device=dev)
    prep3 = pipeline.prepare_frame(scene3, cam3, light3, cfg3, device=dev)
    if prep3.fused or prep3.shadow_bins is not None:
        fail("config 3 did not take the split path without a shadow map")
    list_stats("config3", prep3)
    mb3 = prep3.main_bins
    s1 = tuple(cfg3.sample_positions)
    o_k = raster_cuda.raster_gbuffer(mb3, CW, CH, s1, with_samples=True)
    o_p, k3_plain = timed_once(lambda: raster_cuda.raster_gbuffer_plain(
        mb3, CW, CH, s1, with_samples=True))
    eq = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
             for a, b in zip(o_k, o_p))
    k3_err = float((o_k[0] - o_p[0]).abs().max())
    gout3 = o_k[0]
    covered3 = int((gout3[binning.ROW_DEPTH] > 0).sum())
    say("k3", case="config3", shape=f"{CW}x{CH}xS1", covered_px=covered3,
        gout_depth_winner_bit_equal=eq, max_abs_err=k3_err)
    if not eq or covered3 == 0:
        fail("K3 disagrees with its twin on config 3 (or covered nothing)")
    del o_k, o_p
    k3_ms, k3_dev = timings(lambda: raster_cuda.raster_gbuffer(
        mb3, CW, CH, s1), 50)
    k3_bound = bound(bins_bytes(mb3, True) + nbytes(gout3),
                     raster_ops(mb3, CW, CH, 1, covered3))
    say("k3", case="config3", ms=f"{k3_ms:.4f}", device_ms=f"{k3_dev:.5f}",
        plain_ms=f"{k3_plain:.4f}", bound_ms=f"{k3_bound[0]:.5f}",
        bound_by=k3_bound[1], card=repr(smi))
    tile_walk_split("k3_config3", mb3, lambda bb: raster_cuda.raster_gbuffer(
        bb, CW, CH, s1))
    split_line("k3_config3", mb3, 1, lambda: raster_cuda.raster_gbuffer(
        mb3, CW, CH, s1))
    # K9 on config 3's color lookup (the checkerboard's 10 levels).
    ch3 = raster_cuda.channels_from_gout_px(gout3, 1)
    mips3 = scene3.textures[0]
    args9 = (mip_cuda.build_pyramid(mips3), ch3["u"], ch3["v"],
             shade._texture_lod(ch3["u"], ch3["v"], mips3[0].shape[1],
                                mips3[0].shape[0]),
             (ch3["texid"] == 0) & ch3["covered"], sampling.REPEAT)
    k9_k = mip_cuda.sample_pyramid(*args9)
    k9_p = mip_cuda.sample_pyramid_plain(*args9)
    torch.cuda.synchronize()
    k9_err = max(float((a - b).abs().max()) for a, b in zip(k9_k, k9_p))
    sampled9 = int(args9[4].sum())
    k9_ms, k9_dev = timings(lambda: mip_cuda.sample_pyramid(*args9), 200)
    k9_plain = cuda_ms(lambda: mip_cuda.sample_pyramid_plain(*args9), 20)
    k9_bound = bound(nbytes(args9[0].texels, args9[4], *k9_k)
                     + 12 * sampled9, 94 * sampled9)
    say("k9", case="config3_color", texture=f"{mips3[0].shape[1]}x"
        f"{mips3[0].shape[0]}", levels=len(mips3), sampled_px=sampled9,
        max_abs_err=k9_err, tol=0, ms=f"{k9_ms:.4f}",
        device_ms=f"{k9_dev:.5f}", plain_ms=f"{k9_plain:.4f}",
        bound_ms=f"{k9_bound[0]:.5f}", bound_by=k9_bound[1], card=repr(smi))
    if not k9_err == 0.0 or sampled9 == 0:
        fail("K9 disagrees with its twin on config 3 (or sampled nothing)")
    del ch3, args9, k9_k, k9_p, gout3
    cams3 = orbit(cam3, CFG_FRAMES)
    outs, launches = serve_config(
        "config3", lambda c: pipeline.render_frame(scene3, c, light3, cfg3,
                                                   device=dev),
        lambda c: pipeline.prepare_frame(scene3, c, light3, cfg3, device=dev),
        cams3, {"raster_gbuffer": CFG_FRAMES,
                "sample_pyramid": 2 * CFG_FRAMES}, smi, 4)
    add(launches)
    rows.append(kernel_row("raster_gbuffer<1>@config3", RASTER_SRC,
                           "raster/raster_pallas.py:865",
                           launches["raster_gbuffer"], k3_err, k3_ms, k3_dev, k3_plain, k3_bound))
    rows.append(kernel_row("sample_pyramid@config3", SAMPLE_SRC,
                           "raster/mip_pallas.py:475",
                           launches["sample_pyramid"], k9_err, k9_ms, k9_dev, k9_plain, k9_bound))
    fb_cpu, st_cpu = pipeline.render_frame(scene3.to("cpu"), cams3[-1],
                                           light3, cfg3, device="cpu")
    covf_vs_cpu("config3", *outs[-1], fb_cpu, st_cpu)
    del prep3, mb3, outs, fb_cpu

    # Config 5: the 1M-triangle displaced sphere at 3840x2160, one sample:
    # K2 with no shadow map, and K6 over a 2-frame batch.
    scene5, cam5, light5, cfg5 = configs.config5_animated_high_poly(
        target_tris=C5_TRIS, width=C5_W, height=C5_H, device=dev)
    disps5 = [float(d) for d in np.linspace(0.0, 0.05, C5_FRAMES)]
    prep5, mem5 = peak_mb(lambda: pipeline.prepare_frame(
        scene5, cam5, light5, cfg5, displacement=disps5[-1], device=dev))
    say("configs", config="config5", prep_peak_mem_mb=f"{mem5:.1f}",
        vis_mb=f"{nbytes(prep5.main_bins.vis) / 1e6:.1f}",
        attr_mb=f"{nbytes(prep5.main_bins.attr) / 1e6:.1f}")
    if not prep5.fused or prep5.shadow_bins is not None:
        fail("config 5 did not take the fused path without a shadow map")
    list_stats("config5", prep5)
    k2c5 = fused_twin("config5_4k", prep5, C5_W, C5_H,
                      tuple(cfg5.sample_positions))
    del prep5
    outs, launches = serve_config(
        "config5", lambda d: pipeline.render_frame(
            scene5, cam5, light5, cfg5, displacement=d, device=dev),
        lambda d: pipeline.prepare_frame(scene5, cam5, light5, cfg5,
                                         displacement=d, device=dev),
        disps5, {"render_fused": C5_FRAMES}, smi, 2)
    add(launches)
    rows.append(kernel_row("render_fused<1>@config5_4k", RASTER_SRC,
                           "raster/raster_pallas.py:997",
                           launches["render_fused"], *k2c5))
    # K6 against its twin on 2 frames, and against per-frame K2.
    preps = [pipeline.prepare_frame(scene5, cam5, light5, cfg5,
                                    displacement=d, device=dev)
             for d in disps5[:2]]
    mb52 = raster_cuda.stack_bins([p.main_bins for p in preps])
    uni52 = torch.stack([p.uniforms for p in preps])
    args6 = (mb52, uni52, None, C5_W, C5_H, tuple(cfg5.sample_positions))
    r_k, c_k = raster_cuda.render_fused_batch(*args6)
    (r_p, c_p), k6_plain = timed_once(
        lambda: raster_cuda.render_fused_batch_plain(*args6))
    k6_err = float((r_k - r_p).abs().max())
    k6_eq = torch.equal(c_k, c_p)
    k2_eq = all(torch.equal(r_k[f], outs[f][0]) for f in range(2))
    covered6 = [int((c_k[f] > 0).sum()) for f in range(2)]
    say("k6", case="config5_4k_2_frames", covered_px=covered6,
        covf_equal=k6_eq, rgba_max_abs_err=k6_err, tol=1e-5,
        equal_to_render_frame=k2_eq)
    if not (k6_eq and k6_err <= 1e-5 and k2_eq):
        fail("K6 disagrees with its twin or with render_frame on config 5")
    k6_ms, k6_dev = timings(lambda: raster_cuda.render_fused_batch(*args6),
                            20)
    k6_bound = bound(bins_bytes(mb52, True) + nbytes(uni52, r_k, c_k),
                     sum(raster_ops(raster_cuda.frame_bins(mb52, f), C5_W,
                                    C5_H, 1, covered6[f]) for f in range(2)))
    split_line("k6_config5_4k_2_frames", mb52, 1,
               lambda: raster_cuda.render_fused_batch(*args6))
    say("k6", case="config5_4k_2_frames", ms=f"{k6_ms:.4f}",
        device_ms=f"{k6_dev:.5f}", plain_ms=f"{k6_plain:.4f}",
        bound_ms=f"{k6_bound[0]:.5f}", bound_by=k6_bound[1], card=repr(smi))
    del preps, mb52, r_k, c_k, r_p, c_p
    # One render_batch of the first two frames: one K6, frames equal.
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    (rgba, bst), mem = peak_mb(lambda: render_batch(
        scene5, cam5, light5, disps5[:2], config=cfg5, device=dev))
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    eq = all(torch.equal(rgba[f], outs[f][0]) for f in range(2))
    say("serve_cfg", config="config5_batch", frames=2,
        size=f"{C5_W}x{C5_H}", batch_ms=f"{batch_ms:.4f}",
        per_frame_ms=f"{batch_ms / 2:.4f}", peak_mem_mb=f"{mem:.1f}",
        launches=json.dumps(launches), frames_equal_render_frame=eq,
        card=repr(smi))
    want = {k: 0 for k in launches}
    want["render_fused_batch"] = 1
    if launches != want or not eq:
        fail(f"config 5 batch: launches {launches} != {want}, or frames "
             "unequal to render_frame")
    add(launches)
    rows.append(kernel_row("render_fused_batch<1>@config5_4k_2_frames",
                           RASTER_SRC, "raster/raster_pallas.py:1278",
                           launches["render_fused_batch"], k6_err, k6_ms,
                           k6_dev, k6_plain, k6_bound))
    del rgba, outs
    # The 4K frame's CPU counterpart at a reduced size: the card's frame
    # and the CPU's of the same configuration.
    w, h, tris = C5_CPU
    small5 = configs.config5_animated_high_poly(target_tris=tris, width=w,
                                                height=h, device="cpu")
    fb, st = pipeline.render_frame(small5[0].to(dev), *small5[1:],
                                   displacement=disps5[-1], device=dev)
    fb_cpu, st_cpu = pipeline.render_frame(*small5, displacement=disps5[-1],
                                           device="cpu")
    covf_vs_cpu("config5", fb, st, fb_cpu, st_cpu,
                {"size": f"{w}x{h}", "triangles": tris})
    return rows


def session_script(size, small):
    """Phase 22's session: 40 events as JSON lines — shifted and unshifted
    cursor moves (the first only anchors), drags, a scroll to the minimum
    radius and back, ``set`` of the light colour, the cube and light
    positions and the displacement, a resize to ``small`` and back to
    ``size``, and a closing ``frame`` of 8: 47 frames."""
    ev = [{"type": "cursor", "x": 400.0, "y": 300.0},
          {"type": "cursor", "x": 420.0, "y": 310.0}]
    ev += [{"type": "cursor", "x": 420.0 + 17.0 * i, "y": 310.0 - 6.5 * i,
            "shift": True} for i in range(1, 7)]
    ev += [{"type": "drag", "dx": dx, "dy": dy}
           for dx, dy in ((-30.0, 12.0), (45.5, -8.0), (3.0, 60.0),
                          (-12.25, -40.0))]
    ev += [{"type": "scroll", "dy": 1.0}, {"type": "scroll", "dy": -2.0},
           {"type": "set", "light_color": [1.0, 0.6, 0.3]},
           {"type": "set", "cube_pos": [0.4, 0.1, -1.3]},
           {"type": "set", "light_pos": [0.8, 2.5, 0.3]},
           {"type": "set", "displacement": 0.04},
           {"type": "resize", "width": small[0], "height": small[1]}]
    ev += [{"type": "cursor", "x": 520.0 - 11.0 * i, "y": 270.0 + 9.0 * i,
            "shift": True} for i in range(4)]
    ev += [{"type": "drag", "dx": 20.0, "dy": 5.0},
           {"type": "resize", "width": size[0], "height": size[1]},
           {"type": "scroll", "dy": 100.0}, {"type": "scroll", "dy": -22.0}]
    ev += [{"type": "cursor", "x": 470.0 + 13.0 * i, "y": 305.0 - 4.0 * i,
            "shift": True} for i in range(4)]
    ev += [{"type": "cursor", "x": 600.0, "y": 200.0},
           {"type": "cursor", "x": 640.0, "y": 180.0}]
    ev += [{"type": "drag", "dx": dx, "dy": dy}
           for dx, dy in ((8.0, -3.0), (-25.0, 14.0), (60.0, 0.5),
                          (-5.0, -9.0))]
    ev += [{"type": "set", "light_color": [0.3, 0.8, 1.0],
            "displacement": 0.0},
           {"type": "set", "cube_pos": [0.0, 0.0, -1.0]},
           {"type": "frame", "n": 8}]
    assert len(ev) == 40
    return [json.dumps(e) for e in ev]


def trace_summary(path, frames):
    """Per frame, from a Chrome trace written by ``utils.profiling.
    device_trace``: CUDA launch calls, device events (kernels, copies,
    memsets) and their summed ms; and the kernels' names."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    calls = sum(1 for e in events if str(e.get("name", "")).startswith(
        ("cudaLaunchKernel", "cuLaunchKernel")))
    busy = sum(float(e.get("dur", 0.0)) for e in device) / 1e3
    names = {e["name"] for e in device if e.get("cat") == "kernel"}
    return {"launch_calls": calls / frames,
            "device_events": len(device) / frames,
            "device_busy_ms": busy / frames}, names


def check_launches(what, launches, want):
    full = {k: 0 for k in launches}
    full.update(want)
    if launches != full:
        fail(f"{what}: launch counts {launches} != {full}")


def app_phase(dev, smi, path_launches, sig, rate, serve_ms, batch_ms):
    """Phase 22: the app layer on the card at W x H, 4xMSAA, SHADOW^2: the
    CLI's render (one frame in a subprocess through ``python -m``, one and
    8 in process), flythrough, session, audioapp (offline and streamed),
    analyze --dashboard, and a stream resumed from a checkpoint, each held
    to the in-process entry points. Adds each path's launches to
    ``path_launches``. ``serve_ms``: phase 5's median flagship frame;
    ``batch_ms``: phase 16's flagship batch, ms per frame."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from metalrenderer_tpu_torch import cli
    from metalrenderer_tpu_torch.audio import analyzer, mapping
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, renderer
    from metalrenderer_tpu_torch.engine.session import InteractiveSession
    from metalrenderer_tpu_torch.io import png, wav
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting
    from metalrenderer_tpu_torch.utils import checkpoint, profiling

    devname = "cuda" if dev.type == "cuda" else "cpu"
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    size = ["--width", str(W), "--height", str(H), "--msaa", "4",
            "--shadow-map-size", str(SHADOW)]
    target = (0.0, 0.0, -1.0)
    tmp = Path(tempfile.mkdtemp(prefix="app_phase_"))

    def run_cli(argv, want=None):
        """cli.main(argv) in process with its stdout captured; the launch
        counts must be ``want`` (and go to ``path_launches``). Returns (the
        subcommand's result, its JSON lines, host ms)."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.main(["--device", devname, *argv])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        if want is not None:
            check_launches(f"cli {argv[0]}", launches, want)
        for k, n in launches.items():
            path_launches[k] += n
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        return res, lines, ms

    def files(d, pattern):
        return sorted(p.name for p in Path(d).glob(pattern))

    one = dict(raster_depth=1, render_fused=1)
    batch = dict(raster_depth_batch=1, render_fused_batch=1)
    scene = audio_app.build_scene(device=dev)

    # The module entry point on its own, in a subprocess.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "metalrenderer_tpu_torch.cli", "--device",
         devname, "render", *size, "--out", str(tmp / "sub.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"python -m metalrenderer_tpu_torch.cli render exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    sub_stats = json.loads(proc.stdout.splitlines()[0])

    # render: one frame, then an 8-frame turntable.
    (fb, st), lines, r1_ms = run_cli(["render", *size, "--out",
                                      str(tmp / "one.png")], one)
    want_fb, _ = audio_app.render_audio_app(camera=cam, config=cfg,
                                            device=dev)
    one_eq = torch.equal(fb, want_fb)
    png_eq = np.array_equal(png.read_png(tmp / "one.png"),
                            png.to_u8(fb.cpu().numpy())[..., :3])
    sub_eq = np.array_equal(png.read_png(tmp / "sub.png"),
                            png.read_png(tmp / "one.png"))
    host = fb.cpu().numpy()
    png_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        png.write_png(tmp / f"png_{i}.png", host)
        png_ms.append((time.perf_counter() - t0) * 1e3)
    say("app", cmd="render", frames=1, size=f"{W}x{H}",
        rgba_equal_render_audio_app=one_eq, png_equal_rgba=png_eq,
        subprocess_png_equal=sub_eq, subprocess_s=f"{sub_s:.2f}",
        cli_ms=f"{r1_ms:.4f}", png_ms_per_frame=f"{min(png_ms):.2f}",
        stats_keys_equal=sorted(lines[0]) == sorted(st) == sorted(sub_stats),
        card=repr(smi))
    if not (one_eq and png_eq and sub_eq and sorted(lines[0]) == sorted(st)
            == sorted(sub_stats)):
        fail("cli render: frame, PNG or stats differ from render_audio_app")

    nf = 8
    (fbs, st8), lines, r8_ms = run_cli(
        ["render", *size, "--frames", str(nf), "--orbit", "0.8", "--out",
         str(tmp / "turn.png")], batch)
    thetas = torch.tensor(2.5, dtype=torch.float32) + cli.linspace_f32(
        0.0, 0.8, nf)
    want8, _ = pipeline.render_batch(scene, cam, Lighting.default(),
                                     [0.0] * nf, thetas, config=cfg,
                                     shadow_target=target, device=dev)
    batch_eq = torch.equal(fbs, want8)
    frames_eq = all(torch.equal(fbs[i], pipeline.render_frame(
        scene, dataclasses.replace(cam, theta=float(t)), Lighting.default(),
        cfg, shadow_target=target, device=dev)[0])
        for i, t in enumerate(thetas))
    pngs = files(tmp, "turn_*.png")
    say("app", cmd="render", frames=nf, orbit=0.8, cli_ms=f"{r8_ms:.4f}",
        per_frame_ms=f"{r8_ms / nf:.4f}", frames_equal_render_batch=batch_eq,
        frames_equal_render_frame=frames_eq, pngs=len(pngs),
        stats_keys=sorted(lines[0]) == sorted(st8))
    if not (batch_eq and frames_eq and len(pngs) == nf
            and sorted(lines[0]) == sorted(st8)):
        fail("cli render --frames: frames differ from render_batch or "
             "render_frame, or files or stats are missing")
    del fbs, want8

    # flythrough: three key poses, 8 frames a segment -> 17 PoseCameras in
    # one K4 + K6 batch.
    poses = ["5,2.5,1.2", "4,3.0,1.35", "6,2.0,1.0"]
    frames, _, fly_ms = run_cli(
        ["flythrough", *size, *sum((["--pose", p] for p in poses), []),
         "--frames-per-segment", "8", "--out-dir", str(tmp / "fly")], batch)
    keys = [OrbitCamera(radius=float(r), theta=float(t), phi=float(p),
                        aspect=W / H)
            for r, t, p in (k.split(",") for k in poses)]

    def fly():
        return renderer.render_camera_path(
            scene, Lighting.default(), keys, frames_per_segment=8,
            config=cfg, shadow_target=target, device=dev)
    fly()                                             # warm-up
    (rend, fly_render_ms), fly_mem = peak_mb(lambda: timed_once(fly))
    cams = renderer.camera_path(keys, 8)
    fly_err = max(float((frames[i] - pipeline.render_frame(
        scene, c, Lighting.default(), cfg, shadow_target=target,
        device=dev)[0]).abs().max()) for i, c in enumerate(cams))
    fly_eq = torch.equal(rend, frames)
    nfly = len(cams)
    say("app", cmd="flythrough", frames=nfly, keys=len(keys),
        render_ms=f"{fly_render_ms:.4f}",
        render_ms_per_frame=f"{fly_render_ms / nfly:.4f}",
        flagship_batch8_ms_per_frame=f"{batch_ms:.4f}",
        cli_wall_ms_with_png=f"{fly_ms:.4f}",
        cli_wall_ms_per_frame=f"{fly_ms / nfly:.4f}",
        peak_mem_mb=f"{fly_mem:.1f}", max_abs_err_vs_render_frame=fly_err,
        tol=1e-5, cli_equal_in_process=fly_eq,
        pngs=len(files(tmp / "fly", "fly_*.png")), card=repr(smi))
    if not (nfly == 17 and tuple(frames.shape) == (17, H, W, 4)
            and fly_err <= 1e-5 and fly_eq
            and len(files(tmp / "fly", "fly_*.png")) == 17):
        fail(f"flythrough: frames differ from render_frame at the slerped "
             f"poses by {fly_err} or from the in-process path")
    del frames, rend

    # session: the 40-event script at full size (resize to 1280x720 and
    # back), in process (timed: event to frame on the host) and through the
    # CLI; then 4 frames under the profiler.
    lines = session_script((W, H), (W * 2 // 3, H * 2 // 3))
    script = tmp / "events.jsonl"
    script.write_text("\n".join(lines) + "\n")

    def session(config, device):
        return InteractiveSession(config=config, camera=OrbitCamera(
            radius=5.0, theta=2.5, phi=1.2,
            aspect=config.width / config.height), device=device)

    session(cfg, dev).render_frame()                  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    lat, states, sizes = [], [], []
    sess = session(cfg, dev)
    t_prev = time.perf_counter()
    for fb_s, telem in sess.run(lines):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lat.append((t - t_prev) * 1e3)
        t_prev = t
        states.append(telem["camera"])
        sizes.append((telem["width"], telem["height"]))
    launches = read_counts()
    n_sess = len(states)
    check_launches("session", launches, dict(raster_depth=n_sess,
                                             render_fused=n_sess))
    for k, n in launches.items():
        path_launches[k] += n
    (fb_cli, telems), _, sess_cli_ms = run_cli(
        ["session", *size, "--events", str(script), "--out-dir",
         str(tmp / "sess"), "--png-every", "16"],
        dict(raster_depth=n_sess, render_fused=n_sess))
    cli_eq = ([t["camera"] for t in telems] == states
              and torch.equal(fb_cli, fb_s))
    trace_dir = tmp / "trace"
    with profiling.device_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        for _ in sess.run(['{"type": "frame", "n": 4}']):
            pass
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / 4
    tr, kernel_names = trace_summary(prof.trace_path, 4)
    named = {k: any(k in n for n in kernel_names)
             for k in ("raster_depth_kernel", "render_fused_kernel")}
    say("app", cmd="session", events=len(lines), frames=n_sess,
        sizes=sorted(set(sizes)),
        latency_median_ms=f"{statistics.median(lat):.4f}",
        latency_min_ms=f"{min(lat):.4f}", latency_max_ms=f"{max(lat):.4f}",
        render_audio_app_median_ms=f"{serve_ms:.4f}",
        launches=json.dumps(launches), cli_ms=f"{sess_cli_ms:.4f}",
        cli_equal_in_process=cli_eq, min_radius=min(
            s["radius"] for s in states), card=repr(smi))
    say("app", cmd="session", profiled_frames=4, per="frame",
        **{k: f"{v:.4f}" for k, v in tr.items()},
        wall_ms=f"{prof_wall:.4f}",
        busy_share=f"{tr['device_busy_ms'] / prof_wall:.4f}",
        trace_names=json.dumps(named), card=repr(smi))
    if not (n_sess == 47 and cli_eq and all(named.values())
            and min(s["radius"] for s in states) == 0.5):
        fail("session: frame count, CLI run or trace wrong "
             f"({n_sess} frames, cli equal {cli_eq}, trace {named})")

    # The same script at 160x120 (resize to 96x72 and back) on the card and
    # on the CPU: camera states equal after every event, last frames within
    # 1e-5 (K2's twin bar).
    small = RenderConfig(width=160, height=120, msaa=4, shadow_map_size=256)
    lines_s = session_script((160, 120), (96, 72))
    runs = {}
    for d in (dev, "cpu"):
        out = list(session(small, d).run(lines_s))
        runs[str(d)] = ([t["camera"] for _, t in out], out[-1][0].cpu())
    (st_gpu, fb_gpu), (st_cpu, fb_cpu) = runs[str(dev)], runs["cpu"]
    sess_err = float((fb_gpu - fb_cpu).abs().max())
    say("app", cmd="session", check="card vs CPU", size="160x120",
        camera_states_equal=st_gpu == st_cpu == states,
        last_frame_rgba_max_abs_err=sess_err, tol=1e-5)
    if not (st_gpu == st_cpu == states and sess_err <= 1e-5):
        fail(f"session at 160x120: card and CPU differ ({sess_err})")

    # audioapp: phase 20's signal as a 16-bit WAV; offline, then streamed.
    wav_path = tmp / "signal.wav"
    wav.write_wav(wav_path, sig, int(rate))
    samples, rate = wav.read_wav(wav_path)
    mono = samples[0]
    chunks = mono.shape[0] // analyzer.FFT_SIZE
    (frames, telem), _, aa_ms = run_cli(
        ["audioapp", *size, "--wav", str(wav_path), "--out-dir",
         str(tmp / "aa")], batch)
    want_f, want_t = renderer.render_audio_reactive_sequence(
        mono, rate, camera=cam, config=cfg, device=dev)
    aa_eq = torch.equal(frames, want_f) and all(
        torch.equal(telem[k], want_t[k]) for k in want_t)
    tele = json.loads((tmp / "aa" / "telemetry.json").read_text())
    say("app", cmd="audioapp", frames=chunks, cli_ms=f"{aa_ms:.4f}",
        cli_ms_per_frame=f"{aa_ms / chunks:.4f}",
        frames_equal_sequence=aa_eq, telemetry_keys=sorted(tele),
        pngs=len(files(tmp / "aa", "frame_*.png")))
    if not (aa_eq and sorted(tele) == sorted(want_t)
            and len(files(tmp / "aa", "frame_*.png")) == chunks):
        fail("cli audioapp: frames or telemetry differ from "
             "render_audio_reactive_sequence")
    del want_f
    (sframes, recs), _, st_ms = run_cli(
        ["audioapp", *size, "--wav", str(wav_path), "--out-dir",
         str(tmp / "as"), "--stream", "--chunk-frames", "16"],
        dict(raster_depth_batch=2, render_fused_batch=2))
    stream_err = float((sframes - frames.cpu()).abs().max())
    # What of fetch_ms is the chunk's copy to the host (16 frames, 531 MB).
    _, d2h_ms = timed_once(lambda: frames[:16].cpu())
    say("app", cmd="audioapp --stream", chunk_frames=16,
        fetch_ms=[r["fetch_ms"] for r in recs], cli_ms=f"{st_ms:.4f}",
        chunk_to_host_ms=f"{d2h_ms:.2f}",
        max_abs_diff_vs_offline=stream_err, tol=1e-5, card=repr(smi))
    if not (tuple(sframes.shape) == (chunks, H, W, 4)
            and stream_err <= 1e-5 and len(recs) == 2):
        fail(f"cli audioapp --stream differs from the offline run by "
             f"{stream_err}")
    del frames

    # Checkpoint: the stream split at chunk 16, the analyzer and visual
    # states saved and restored, equal to the unbroken stream.
    a_state, v_state, _, _ = renderer.audio_visual_track(
        mono[:16 * analyzer.FFT_SIZE], rate, device=dev)
    ckpt = tmp / "stream_state.npz"
    checkpoint.save_pytree(ckpt, (a_state, v_state))
    a_rest, v_rest = checkpoint.restore_like(
        (analyzer.AnalyzerState.init(), mapping.VisualState.init()), ckpt)
    reset_counts()
    resumed = torch.cat([f for f, _ in renderer.stream_audio_reactive(
        mono[16 * analyzer.FFT_SIZE:], rate, chunk_frames=16, camera=cam,
        config=cfg, device=dev, analyzer_state=a_rest,
        visual_state=v_rest)])
    launches = read_counts()
    check_launches("resumed stream", launches, batch)
    for k, n in launches.items():
        path_launches[k] += n
    resume_eq = torch.equal(resumed.cpu(), sframes[16:])
    say("app", check="checkpoint resume", split_chunk=16,
        leaves=len(checkpoint.load_leaves(ckpt)),
        resumed_equal_unbroken=resume_eq)
    if not resume_eq:
        fail("the stream resumed from a checkpoint differs from the "
             "unbroken stream")
    del sframes, resumed

    # analyze --dashboard on the card against the CPU run.
    # The analyzer's carries: one launch over the 32 chunks.
    _, gpu_lines, an_ms = run_cli(["analyze", "--wav", str(wav_path),
                                   "--dashboard", str(tmp / "dash")],
                                  {"track_carries": 1})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "analyze", "--wav", str(wav_path)])
    cpu_lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    # Phase 20's track bar: 1e-5 relative (|b| floored at 0.1); the
    # melancholy 1e-4 absolute (tests/test_torch_audio.py's bar: minor- and
    # major-third sums of a tone's leakage bins, where cuFFT and the CPU
    # FFT part at ~1e-7 of the peak).
    errs = {k: max(abs(g[k] - c[k]) / max(abs(c[k]), 0.1)
                   for g, c in zip(gpu_lines, cpu_lines))
            for k in cpu_lines[0] if k != "chunk"}
    ok = (len(gpu_lines) == len(cpu_lines) == chunks
          and all(v <= (1e-4 if k == "melancholy" else 1e-5)
                  for k, v in errs.items()))
    dash = files(tmp / "dash", "dash_*.png")
    say("app", cmd="analyze --dashboard", chunks=len(gpu_lines),
        cli_ms=f"{an_ms:.4f}", dashboards=len(dash),
        max_rel_err_vs_cpu=json.dumps({k: float(f"{v:.3g}")
                                       for k, v in errs.items()}))
    if not (ok and len(dash) == chunks):
        fail(f"cli analyze on the card differs from the CPU run: {errs}")
    shutil.rmtree(tmp, ignore_errors=True)


def frames_vs_kernels(name, ref_fn, kern_fn, smi):
    """Render ``ref_fn`` (the reference backend) after a warm-up, three
    times, checking it launches no kernel, and ``kern_fn`` (the kernels);
    print the reference's median ms, PSNR and max abs diff against the
    kernels' frame and both covered fractions; fail below 40 dB. Returns
    the reference frame."""
    import numpy as np
    import torch
    ref_fn()
    torch.cuda.synchronize()
    reset_counts()
    ms, outs = timed_frames(lambda _: ref_fn(), range(3))
    launches = read_counts()
    check_launches(f"reference {name}", launches, {})
    fb, st = outs[-1]
    fb_k, st_k = kern_fn()
    a = np.clip(fb.cpu().numpy(), 0, 1)
    b = np.clip(fb_k.cpu().numpy(), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    err = float((fb - fb_k).abs().max())
    say("reference", frame=name, size=f"{fb.shape[1]}x{fb.shape[0]}",
        reference_ms=f"{statistics.median(ms):.4f}",
        psnr_vs_kernels_db=f"{psnr:.3f}", max_abs_diff_vs_kernels=err,
        covered_fraction=float(st["covered_fraction"]),
        covered_fraction_kernels=float(st_k["covered_fraction"]),
        launches=json.dumps(launches), card=repr(smi))
    if not (psnr >= 40.0 and bool(torch.isfinite(fb).all())):
        fail(f"reference {name}: {psnr:.3f} dB against the kernels (< 40) "
             "or a non-finite frame")
    return fb


def winners_vs_brute_force(name, prep_k, prep_r, width, height, samples,
                           anchor, smi, kernel="k3s"):
    """K3s's winner plane (``kernel="k3"``: K3's per-sample winners, the
    split walk's) on the kernels' bins against the brute force's winners
    on the same triangle setup: the differing samples and how many of them
    are z-fights (both triangles cover the sample at depths within 2 ulp).
    Any other difference fails: it would be a fault of the tile lists or
    of the walk. The kernel runs here as a comparison, not on a path.
    Returns its winners i32[S, H, W]."""
    import torch
    from metalrenderer_tpu_torch.raster import raster_cuda, reference_cpu
    if kernel == "k3":
        _, _, win_k = raster_cuda.raster_gbuffer(
            prep_k.main_bins, width, height, samples, with_samples=True)
    else:
        _, _, win_k = raster_cuda.raster_gbuffer_samples(
            prep_k.main_bins, width, height, samples)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, win_r = reference_cpu.rasterize_brute_force(
        prep_r.main_setup, width, height, samples, anchor)
    torch.cuda.synchronize()
    brute_ms = (time.perf_counter() - t0) * 1e3
    idx = torch.nonzero((win_k != win_r).reshape(-1)).squeeze(1)
    depths = [reference_cpu.depth_at_samples(
        prep_r.main_setup, width, height, samples, idx,
        w.reshape(-1)[idx], anchor) for w in (win_k, win_r)]
    (z0, h0), (z1, h1) = depths
    ulps = (z0.view(torch.int32).to(torch.int64)
            - z1.view(torch.int32).to(torch.int64)).abs()
    zfights = int((h0 & h1 & (ulps <= 2)).sum())
    cnt = candidate_counts(prep_k.main_bins)
    say("reference", check=f"{kernel.upper()} winners vs brute force",
        case=name,
        size=f"{width}x{height}xS{len(samples)}",
        slots=prep_r.main_setup.valid.numel(),
        covered_samples=int((win_r >= 0).sum()),
        max_tile_candidates=int(cnt.max()), differing=int(idx.numel()),
        zfights=zfights, brute_force_ms=f"{brute_ms:.3f}", card=repr(smi))
    # K3 splits these configs' long lists over blocks: held to no sample
    # apart, z-fights included (K3s's winners met that in every run).
    if zfights != idx.numel() or (kernel == "k3" and idx.numel()):
        fail(f"{name}: {idx.numel()} samples where {kernel.upper()} and the "
             f"brute force pick different winners ({zfights} z-fights)")
    return win_k


def entry_points(dev):
    """``backend="reference"`` through every entry point on the card at
    160x120: ``render``, ``render_batch`` (frame by frame), the session,
    the camera path, the audio-reactive sequence and the CLI, each frame
    equal to ``render_frame``'s where it is the same frame; no raster
    kernel launched (the sequence's track launches its carries kernels
    once, op by op)."""
    import tempfile

    import numpy as np
    import torch
    from metalrenderer_tpu_torch import cli, render, render_batch
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, renderer
    from metalrenderer_tpu_torch.engine.session import InteractiveSession
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting
    cfg = RenderConfig(width=160, height=120, msaa=4, shadow_map_size=256)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=160 / 120)
    kw = dict(backend="reference", device=dev)
    scene = audio_app.build_scene(device=dev)
    target = (0.0, 0.0, -1.0)
    reset_counts()
    one, _ = pipeline.render_frame(scene, cam, Lighting.default(), cfg,
                                   shadow_target=target, **kw)
    same = {
        "render": torch.equal(render(scene, cam, Lighting.default(), cfg,
                                     shadow_target=target, **kw)[0], one),
        "render_batch": bool(torch.equal(render_batch(
            scene, cam, Lighting.default(), [0.0, 0.0], [2.5, 2.5],
            config=cfg, shadow_target=target, **kw)[0],
            torch.stack([one, one]))),
        "session": torch.equal(InteractiveSession(
            config=cfg, camera=cam, **kw).render_frame()[0],
            audio_app.render_audio_app(config=cfg, camera=cam, **kw)[0]),
    }
    path = renderer.render_camera_path(scene, Lighting.default(),
                                       [cam.pose(), cam.pose()], 2,
                                       config=cfg, **kw)
    t = np.arange(2 * 1024) / 48000.0
    seq, _ = renderer.render_audio_reactive_sequence(
        (0.01 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32), 48000.0,
        camera=cam, config=cfg, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        fb_cli, _ = cli.main(["--device", torch.device(dev).type, "render",
                              "--backend", "reference", "--width",
                              "160", "--height", "120", "--shadow-map-size",
                              "256", "--out", f"{tmp}/f.png"])
    same["cli"] = torch.equal(fb_cli, audio_app.render_audio_app(
        config=cfg, camera=cam, **kw)[0])
    finite = all(bool(torch.isfinite(x).all()) for x in (path, seq))
    launches = read_counts()
    say("reference", check="entry points", size="160x120",
        equal_render_frame=json.dumps(same),
        camera_path=tuple(path.shape), sequence=tuple(seq.shape),
        finite=finite, launches=json.dumps(launches))
    # No raster kernel; the 2-chunk track's first call runs op by op on
    # the card (its carries kernels), whatever the backend.
    check_launches("reference entry points", launches,
                   {"track_carries": 1, "track_envelope": 1})
    if not (all(same.values()) and finite and path.shape[0] == 3
            and seq.shape[0] == 2):
        fail("an entry point's reference frame differs from render_frame's")


def reference_phase(dev, smi):
    """Phase 23: the brute-force reference backend on the card. Frames of
    the flagship (W x H, 4xMSAA, SHADOW^2), config 4, config 3 at one sample
    and the 800x600 flagship against the kernels' frames (>= 40 dB; the
    800x600 one also against its golden), K3s's winners against the brute
    force's on configs 3 (1080p) and 5 (3840x2160) and the flagship, and a
    160x120 reference frame on the card against the CPU's (1e-5)."""
    import torch
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.io import png
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    t_phase = time.perf_counter()

    def flagship(w, h, msaa=4, shadow=SHADOW):
        cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
        cfg = RenderConfig(width=w, height=h, msaa=msaa,
                           shadow_map_size=shadow)
        return cam, cfg

    cam, cfg = flagship(W, H)
    scene = audio_app.build_scene(device=dev)
    frames_vs_kernels(
        "flagship", lambda: audio_app.render_audio_app(
            camera=cam, config=cfg, backend="reference", device=dev,
            scene=scene),
        lambda: audio_app.render_audio_app(camera=cam, config=cfg,
                                           device=dev, scene=scene), smi)
    s4 = configs.config4_shadow_normal_map(W, H, device=dev)
    frames_vs_kernels(
        "config4", lambda: pipeline.render_frame(*s4, backend="reference",
                                                 device=dev),
        lambda: pipeline.render_frame(*s4, device=dev), smi)
    s3 = configs.config3_high_poly(target_tris=C3_TRIS, width=CW, height=CH,
                                   device=dev)
    frames_vs_kernels(
        "config3", lambda: pipeline.render_frame(*s3, backend="reference",
                                                 device=dev),
        lambda: pipeline.render_frame(*s3, device=dev), smi)
    cam8, cfg8 = flagship(800, 600, shadow=1024)    # the golden's
    fb8 = frames_vs_kernels(
        "flagship_800x600", lambda: audio_app.render_audio_app(
            camera=cam8, config=cfg8, backend="reference", device=dev,
            scene=scene),
        lambda: audio_app.render_audio_app(camera=cam8, config=cfg8,
                                           device=dev, scene=scene), smi)
    psnr = psnr_db(fb8, png.read_png(ROOT / "tests" / "goldens"
                                     / "audio_app_800x600.png"))
    say("reference", frame="flagship_800x600", psnr_vs_golden_db=f"{psnr:.3f}",
        bar=40)
    if not psnr >= 40.0:
        fail(f"reference 800x600 golden PSNR {psnr:.3f} dB < 40")

    # K3s against the brute force: the independent check of the tile walk.
    for name, (sc, cm, lt, cf) in (
            ("config3", s3),
            ("config5_4k", configs.config5_animated_high_poly(
                target_tris=C5_TRIS, width=C5_W, height=C5_H, device=dev)),
            ("flagship", (scene, cam, Lighting(
                light=PointLight(), ambient_intensity=0.1, shininess=32.0),
                cfg))):
        kw = dict(shadow_target=(0.0, 0.0, -1.0)) if name == "flagship" \
            else {}
        prep_k = pipeline.prepare_frame(sc, cm, lt, cf, device=dev, **kw)
        prep_r = pipeline.prepare_frame(sc, cm, lt, cf, backend="reference",
                                        device=dev, **kw)
        # K3 (one sample on configs 3 and 5) walks their long lists split
        # over blocks: its per-sample winners too.
        for kernel in ("k3s", "k3") if name != "flagship" else ("k3s",):
            winners_vs_brute_force(name, prep_k, prep_r, cf.width,
                                   cf.height, tuple(cf.sample_positions),
                                   (cf.tile_w, cf.tile_h), smi, kernel)
        del prep_k, prep_r

    # Every entry point takes the reference backend on the card.
    entry_points(dev)

    # The card against the CPU.
    cam_s, cfg_s = flagship(160, 120, shadow=256)
    fb_gpu, _ = audio_app.render_audio_app(camera=cam_s, config=cfg_s,
                                           backend="reference", device=dev)
    fb_cpu, _ = audio_app.render_audio_app(camera=cam_s, config=cfg_s,
                                           backend="reference", device="cpu")
    err = float((fb_gpu.cpu() - fb_cpu).abs().max())
    say("reference", check="card vs CPU", size="160x120",
        rgba_max_abs_err=err, tol=1e-5,
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    if not err <= 1e-5:
        fail(f"the reference frame on the card differs from the CPU's by "
             f"{err}")


# The one-frame kernel wrappers a frame's path calls, by module, and their
# plain twins.
PATH_WRAPPERS = {
    "raster_cuda": ("raster_depth", "render_fused", "raster_gbuffer",
                    "raster_gbuffer_samples"),
    "mip_cuda": ("sample_pyramid",),
    "sample_cuda": ("sample_bilinear",),
}


def recorded_calls(fn):
    """Run ``fn`` while the one-frame kernel wrappers record their calls:
    (fn's result, [(wrapper, args, kwargs, its outputs cloned)]). The
    wrappers launch their kernels and count as ever."""
    import torch
    from metalrenderer_tpu_torch.raster import (mip_cuda, raster_cuda,
                                                sample_cuda)
    mods = {"raster_cuda": raster_cuda, "mip_cuda": mip_cuda,
            "sample_cuda": sample_cuda}
    calls, saved = [], {}

    def clone(out):
        if isinstance(out, tuple):
            return tuple(clone(o) for o in out)
        return out.clone() if isinstance(out, torch.Tensor) else out

    def recorder(name, wrapper):
        def call(*args, **kw):
            out = wrapper(*args, **kw)
            calls.append((name, args, kw, clone(out)))
            return out
        return call

    try:
        for mod, names in PATH_WRAPPERS.items():
            for name in names:
                saved[mod, name] = getattr(mods[mod], name)
                setattr(mods[mod], name, recorder(name, saved[mod, name]))
        result = fn()
    finally:
        for (mod, name), wrapper in saved.items():
            setattr(mods[mod], name, wrapper)
    return result, calls


def twins_hold(what, calls):
    """Each recorded kernel call against its plain twin on the same inputs,
    at the bars of the phases that introduced them: depth, G-buffer and
    winners bit-equal (K1, K3, K3s), K2's coverage equal and its rgba within
    1e-5, K9's and K7's samples equal. Fails on any other difference;
    returns ({wrapper: calls checked}, the largest difference)."""
    import torch
    from metalrenderer_tpu_torch.raster import (mip_cuda, raster_cuda,
                                                sample_cuda)
    mods = {"raster_cuda": raster_cuda, "mip_cuda": mip_cuda,
            "sample_cuda": sample_cuda}
    plain = {name: getattr(mods[mod], name + "_plain")
             for mod, names in PATH_WRAPPERS.items() for name in names}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    checked, worst = {}, 0.0
    for name, args, kw, out in calls:
        ref = plain[name](*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        pairs = [(a, b) for a, b in zip(outs, refs)
                 if a is not None or b is not None]
        if len(outs) != len(refs) or any(a is None or b is None
                                          for a, b in pairs):
            fail(f"{what}: {name} and its twin return different outputs")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
        worst = max(worst, err)
        if name == "render_fused":
            ok = torch.equal(outs[1], refs[1]) and err <= 1e-5
        elif name.startswith("sample_"):
            ok = err == 0.0
        else:
            ok = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
        if not ok:
            fail(f"{what}: {name} differs from its twin by {err}")
        checked[name] = checked.get(name, 0) + 1
    return checked, worst


def parallel_phase(dev, smi, path_launches):
    """Phase 24: multi-device rendering on the one card. A world-size-1 NCCL
    group (file store in a temporary directory): ``render_frame_batch`` of
    BATCH flagship frames (one K4 + one K6, bit-equal to ``render_batch``)
    and ``render_tile_sharded`` (bit-equal to ``render_frame``), gathered
    over NCCL. Then the flagship (W x H) in 2 and 4 bands and config 3 in 4,
    every band in turn through ``sharding.render_band``'s parts: per band
    its triangles, drops, prep and render ms beside the unsharded frame's
    (config 3: its longest tile list), every kernel call of the band
    against its twin, the reference backend's band (>= 40 dB) and K3s's
    winners against the brute force's on the band's setup. The assembled
    frame: its pixels beyond 1e-4 of the unsharded one printed, the
    reference backend's too (JAX's bands differ likewise), >= 40 dB, and at most BAND_FLIPS of its samples
    covered otherwise by K3s. Adds each path's launches to
    ``path_launches``."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from metalrenderer_tpu_torch import render_batch
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.parallel import sharding
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import raster_cuda
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    t_phase = time.perf_counter()

    def add(launches):
        for k, n in launches.items():
            path_launches[k] += n

    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW)
    lighting = Lighting(light=PointLight(), ambient_intensity=0.1,
                        shininess=32.0)
    scene = audio_app.build_scene(device=dev)
    target = (0.0, 0.0, -1.0)
    disps = [float(d) for d in np.linspace(0.0, 0.05, BATCH)]
    thetas = [2.5 + 0.01 * i for i in range(BATCH)]

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = sharding.make_mesh(1)
            if mesh.group is None or mesh.device != torch.device(dev):
                fail(f"make_mesh gave {mesh}")
            sharding.render_frame_batch(scene, cam, lighting, disps, thetas,
                                        mesh, cfg, shadow_target=target)
            torch.cuda.synchronize()
            reset_counts()
            fbs, ms = timed_once(lambda: sharding.render_frame_batch(
                scene, cam, lighting, disps, thetas, mesh, cfg,
                shadow_target=target))
            launches = read_counts()
            check_launches("render_frame_batch", launches,
                           {"raster_depth_batch": 1, "render_fused_batch": 1})
            add(launches)
            rgba, _ = render_batch(scene, cam, lighting, disps, thetas,
                                   config=cfg, shadow_target=target,
                                   device=dev)
            eq_batch = torch.equal(fbs, rgba)
            reset_counts()
            fb_t, ms_t = timed_once(lambda: sharding.render_tile_sharded(
                scene, cam, lighting, mesh, cfg, shadow_target=target))
            launches_t = read_counts()
            check_launches("render_tile_sharded", launches_t,
                           {"raster_depth": 1, "render_fused": 1})
            add(launches_t)
            fb_1, _ = pipeline.render_frame(scene, cam, lighting, cfg,
                                            shadow_target=target, device=dev)
            eq_tile = torch.equal(fb_t, fb_1)
            say("parallel", group="nccl world_size=1",
                frame_batch=f"{BATCH}x{W}x{H}", frame_batch_ms=f"{ms:.3f}",
                frame_batch_launches=json.dumps(launches),
                equal_render_batch=eq_batch, tile_sharded_ms=f"{ms_t:.3f}",
                equal_render_frame=eq_tile, card=repr(smi))
            if not (eq_batch and eq_tile):
                fail("the world-size-1 group's frames differ from the "
                     "unsharded entry points")
        finally:
            dist.destroy_process_group()
    del fbs, rgba

    s3 = configs.config3_high_poly(target_tris=C3_TRIS, width=CW, height=CH,
                                   device=dev)
    cases = (("flagship", 2, (scene, cam, lighting, cfg), target),
             ("flagship", 4, (scene, cam, lighting, cfg), target),
             ("config3", 4, s3, (0.0, 0.0, 0.0)))
    for name, n, (sc, cm, lt, cf), tg in cases:
        samples = tuple(cf.sample_positions)

        def prep_full():
            return pipeline.prepare_frame(sc, cm, lt, cf, shadow_target=tg,
                                          device=dev)
        fb_full, _ = pipeline.render_prepared(prep_full(), cf)   # warm-up
        prep, prep_ms = timed_once(prep_full)
        (fb_full, _), render_ms = timed_once(
            lambda: pipeline.render_prepared(prep, cf))
        reset_counts()
        bands, preps, rows = [], [], []
        for b in range(n):
            (bprep, bcfg, n_in, dropped), bprep_ms = timed_once(
                lambda: sharding.prepare_band(sc, cm, lt, b, n, cf,
                                              shadow_target=tg, device=dev))
            (fb_b, _), brender_ms = timed_once(
                lambda: pipeline.render_prepared(bprep, bcfg))
            bands.append(fb_b)
            preps.append((bprep, bcfg))
            off = bprep.main_bins.tile_offsets
            rows.append({"band": b, "band_triangles": int(n_in),
                         "band_dropped": int(dropped),
                         "prep_ms": round(bprep_ms, 4),
                         "render_ms": round(brender_ms, 4),
                         "longest_tile_list": int((off[1:] - off[:-1]).max())})
        launches = read_counts()
        add(launches)
        per = ({"raster_depth": 1, "render_fused": 1} if name == "flagship"
               else {"raster_gbuffer": 1, "sample_pyramid": 2})
        check_launches(f"{name} in {n} bands", launches,
                       {k: n * v for k, v in per.items()})

        # Each band on its own setup: its kernels' calls replayed through
        # their twins, the reference backend's band (>= 40 dB, as phase 23
        # holds whole frames), and K3s's winners against the brute force's.
        # The bands' coverage is then K3s's, held against K3s's on the
        # unsharded frame.
        win_full = raster_cuda.raster_gbuffer_samples(
            prep.main_bins, cf.width, cf.height, samples)[2]
        fb_full_r, _ = pipeline.render_frame(sc, cm, lt, cf, shadow_target=tg,
                                             backend="reference", device=dev)
        covered, bands_r = [], []
        for b, ((bprep, bcfg), row) in enumerate(zip(preps, rows)):
            what = f"{name}x{n}_band{b}"
            (fb_b, _), calls = recorded_calls(
                lambda: pipeline.render_prepared(bprep, bcfg))
            checked, twin_err = twins_hold(what, calls)
            if checked != per or not torch.equal(fb_b, bands[b]):
                fail(f"{what}: the band's kernels {checked} (want {per}), "
                     "or its frame differs on a second render")
            rprep, _, _, _ = sharding.prepare_band(
                sc, cm, lt, b, n, cf, shadow_target=tg, backend="reference",
                device=dev)
            reset_counts()
            fb_r, _ = pipeline.render_prepared(rprep, bcfg)
            check_launches(f"{what} on the reference backend", read_counts(),
                           {})
            psnr_r = psnr_frames(fb_r, bands[b])
            win_b = winners_vs_brute_force(
                what, bprep, rprep, bcfg.width, bcfg.height, samples,
                (cf.tile_w, cf.tile_h), smi)
            covered.append(win_b >= 0)
            bands_r.append(fb_r)
            row.update(twins=checked, twin_max_abs_err=twin_err,
                       psnr_vs_reference_band_db=round(psnr_r, 3))
            if not (psnr_r >= 40.0 and bool(torch.isfinite(fb_r).all())):
                fail(f"{what}: {psnr_r:.3f} dB between the kernels' band and "
                     "the reference backend's (< 40)")
            del calls, rprep
        flips = int((torch.cat(covered, dim=1) != (win_full >= 0)).sum())

        fb_bands = torch.cat(bands)
        diff = (fb_bands - fb_full).abs().amax(-1)
        psnr = psnr_frames(fb_bands, fb_full)
        over = int((diff > 1e-4).sum())
        diff_r = (torch.cat(bands_r) - fb_full_r).abs().amax(-1)
        # A band's last row takes its screen-space differences (texture LOD)
        # from the band's first row, where the frame takes them from the
        # next band's: those rows are counted apart.
        inner = torch.ones(cf.height, dtype=torch.bool, device=diff.device)
        inner[cf.height // n - 1::cf.height // n] = False
        off = prep.main_bins.tile_offsets
        say("parallel", bands=f"{name}x{n}", size=f"{cf.width}x{cf.height}",
            unsharded_prep_ms=f"{prep_ms:.4f}",
            unsharded_render_ms=f"{render_ms:.4f}",
            unsharded_longest_tile_list=int((off[1:] - off[:-1]).max()),
            per_band=json.dumps(rows), psnr_vs_unsharded_db=f"{psnr:.3f}",
            max_abs_err_vs_unsharded=float(diff.max()),
            pixels_over_1em4=over, within_1em4=over == 0,
            off_band_last_rows=int((diff[inner] > 1e-4).sum()),
            reference_max_abs_err_vs_unsharded=float(diff_r.max()),
            reference_pixels_over_1em4=int((diff_r > 1e-4).sum()),
            reference_off_band_last_rows=int((diff_r[inner] > 1e-4).sum()),
            coverage_flips=flips, samples=win_full.numel(),
            launches=json.dumps(launches), card=repr(smi))
        # 1e-4 from the unsharded frame is printed and not held: a band
        # renders through BandedCamera's projection, which rounds clip space
        # otherwise, so a sample within rounding of an edge may change
        # triangle and the shading's screen-space differences amplify it.
        # The JAX package's own bands differ from its unsharded frame so at
        # these sizes (tests/torch_band_witness.py).
        # What a fault would change is held instead: every band's kernels
        # against their twins and the oracle (above), no triangle dropped,
        # the frame >= 40 dB from the unsharded one, and coverage sample by
        # sample: a dropped or misplaced triangle uncovers whole triangles.
        if (psnr < 40.0 or flips > BAND_FLIPS * win_full.numel()
                or any(r["band_dropped"] for r in rows)):
            fail(f"{name} in {n} bands: {psnr:.3f} dB from the unsharded "
                 f"frame, {flips} samples covered differently, or triangles "
                 "dropped")
        del bands, preps, covered, win_full, fb_bands, bands_r, fb_full_r
    say("parallel", phase_s=f"{time.perf_counter() - t_phase:.1f}")


def prep_graph_phase(dev, smi):
    """Phase 25: the prep graph (``prep.PREP_GRAPH``) against the prep run
    op by op (``prep.prepare(..., graphed=False)``) on the card:
    the flagship frame, config 4 (the split path) and config 5 (1M
    triangles at 3840x2160), each from an empty cache (a shape's first
    frame runs op by op, its second captures) and replayed at a second
    displacement and camera, and an 8-frame AudioApp batch through
    ``render_frame_batch_fused`` with eight displacements and light colors.
    Every prep's tables, the batch's stacked tables and its frames are
    bit-equal to the op-by-op prep's. Per case, op by op and graphed: the
    prep's host ms (call to return, the device idle before; the graphed
    prep as the render functions take it, uncopied), its launch calls and
    device-busy ms under torch.profiler (the profiler's sum of device
    event times); the graph's device ms (its replays back to back, CUDA
    events; a frame's replays for the batch); the first frame's ms, the
    capture's ms, the memory it reserved (the graph's pool with its static
    inputs) and its peak. Then the costs the capture policy bounds: a
    one-off ``render_frame`` of a new shape, and an interactive session
    resized every frame through six sizes, three rounds (each frame's
    ms, with its sync)."""
    import gc

    import numpy as np
    import torch
    from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs, session
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.passes import prep as frame_prep
    from metalrenderer_tpu_torch.raster.binning import TileBins
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight

    def same(a, b):
        ta, tb = frame_prep.tables(a), frame_prep.tables(b)
        return len(ta) == len(tb) and all(
            x.shape == y.shape and torch.equal(x.reshape(-1).view(
                torch.int32), y.reshape(-1).view(torch.int32))
            for x, y in zip(ta, tb))

    def host_ms(fn, reps):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(ms)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def measure(eager, graphed, reps, replays):
        e_prof = profile_frames(lambda _: eager(), [None] * 2)
        g_prof = profile_frames(lambda _: graphed(), [None] * 2)
        graph, = frame_prep.PREP_GRAPH.graphs.values()

        def replay():
            for _ in range(replays):
                graph.graph.replay()
        return dict(
            eager_host_ms=f"{host_ms(eager, reps):.4f}",
            graph_host_ms=f"{host_ms(graphed, reps):.4f}",
            eager_launch_calls=f"{e_prof['launch_calls']:.1f}",
            graph_launch_calls=f"{g_prof['launch_calls']:.1f}",
            eager_device_busy_ms=f"{e_prof['device_busy_ms']:.4f}",
            graph_device_busy_ms=f"{g_prof['device_busy_ms']:.4f}",
            graph_replay_ms=f"{cuda_ms(replay, reps):.4f}")

    def fresh_capture(fn):
        """fn() twice from an empty cache, the first op by op, the second
        capturing: (the second's output, the first's ms, the second's ms,
        reserved bytes the capture added, peak allocated bytes)."""
        frame_prep.PREP_GRAPH.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        c0 = frame_prep.PREP_GRAPH.captures
        _, first_ms = wall_ms(fn)
        if frame_prep.PREP_GRAPH.captures != c0:
            fail("prep_graph: the first frame of a shape captured")
        r0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out, ms = wall_ms(fn)
        if frame_prep.PREP_GRAPH.captures != c0 + 1:
            fail("prep_graph: the second frame of a shape did not capture")
        return (out, first_ms, ms, torch.cuda.memory_reserved() - r0,
                torch.cuda.max_memory_allocated())

    target = (0.0, 0.0, -1.0)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=SHADOW)
    light = Lighting(light=PointLight(), ambient_intensity=0.1,
                     shininess=32.0)
    cases = (
        ("flagship", lambda: (audio_app.build_scene(device=dev), cam, light,
                              cfg), target, (0.05, 0.3), 5),
        ("config4", lambda: configs.config4_shadow_normal_map(
            W, H, device=dev), (0.0, 0.0, 0.0), (0.0, 0.0), 5),
        ("config5_4k", lambda: configs.config5_animated_high_poly(
            target_tris=C5_TRIS, width=C5_W, height=C5_H, device=dev),
         (0.0, 0.0, 0.0), (0.02, 0.04), 3))
    for name, build, tg, (d0, d1), reps in cases:
        sc, cm, lt, cf = build()
        cams = (cm, dataclasses.replace(cm, theta=float(cm.theta) + 0.1))

        def eager(d=d0, c=cams[0]):
            return frame_prep.prepare(sc, c, lt, cf, ShadowConfig(), d, tg,
                                      dev, None, graphed=False)

        def graphed(d=d0, c=cams[0]):
            return frame_prep.prepare(sc, c, lt, cf, ShadowConfig(), d, tg,
                                      dev, None, graphed=True)
        g, first_ms, cap_ms, pool, peak = fresh_capture(graphed)
        equal = [g.static and same(g, eager())]
        r0 = frame_prep.PREP_GRAPH.replays
        equal.append(same(graphed(d1, cams[1]), eager(d1, cams[1])))
        if frame_prep.PREP_GRAPH.replays != r0 + 1:
            fail(f"prep_graph: {name}'s third frame did not replay")
        say("prep_graph", case=name, bit_equal=json.dumps(equal),
            first_frame_ms=f"{first_ms:.1f}", capture_ms=f"{cap_ms:.1f}",
            pool_reserved_bytes=pool, capture_peak_bytes=peak,
            **measure(eager, graphed, reps, 1), card=repr(smi))
        if not all(equal):
            fail(f"prep_graph: {name}'s graphed prep differs from the "
                 "op-by-op prep")
        del g, sc, cm, lt, cf

    # The AudioApp batch: 8 frames, 8 displacements and light colors.
    colors = [(1.0, 1.0, 1.0), (1.0, 0.2, 0.1), (0.2, 1.0, 0.3),
              (0.1, 0.3, 1.0), (0.9, 0.9, 0.1), (0.5, 0.5, 0.5),
              (1.0, 0.6, 0.0), (0.3, 0.0, 0.8)]
    scenes = [audio_app.build_scene(light_color=c, device=dev)
              for c in colors]
    lights = [Lighting(light=PointLight(color=c), ambient_intensity=0.1,
                       shininess=32.0) for c in colors]
    disps = [float(d) for d in np.linspace(0.0, 0.05, BATCH - 1)] + [5.0]
    thetas = [2.5 + 0.02 * f for f in range(BATCH)]
    cams = [dataclasses.replace(cam, theta=t) for t in thetas]

    def batch():
        return pipeline.render_frame_batch_fused(
            scenes[0], cam, lights[0], cfg, ShadowConfig(), disps, thetas,
            shadow_target=target, scene_fn=lambda f: scenes[f],
            lighting_fn=lambda f: lights[f], frame_params=list(range(BATCH)),
            device=dev)

    def eager_preps():
        return [frame_prep.prepare(scenes[f], cams[f], lights[f], cfg,
                                   ShadowConfig(), disps[f], target, dev,
                                   None, graphed=False)
                for f in range(BATCH)]

    def graphed_preps():
        for f in range(BATCH):
            yield frame_prep.prepare(scenes[f], cams[f], lights[f], cfg,
                                     ShadowConfig(), disps[f], target, dev,
                                     None, graphed=True)

    def graphed_stack():
        return pipeline.stack_preps(graphed_preps(), BATCH)
    frame_prep.PREP_GRAPH.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    c0 = frame_prep.PREP_GRAPH.captures
    (rgba, _), batch_ms = wall_ms(batch)
    pool, peak = (torch.cuda.memory_reserved() - r0,
                  torch.cuda.max_memory_allocated())
    if frame_prep.PREP_GRAPH.captures != c0 + 1:
        fail("prep_graph: the batch's frames did not capture one graph")
    eagers = eager_preps()
    frames_equal = all(
        torch.equal(rgba[f], pipeline.render_prepared(eagers[f], cfg)[0])
        for f in range(BATCH))
    got, want = graphed_stack(), pipeline.stack_preps(eagers, BATCH)
    tables_equal = torch.equal(got.uniforms, want.uniforms) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for b in ("shadow_bins", "main_bins") for k in TileBins.TABLES
        for x, y in [(getattr(getattr(got, b), k),
                      getattr(getattr(want, b), k))])
    m = measure(lambda: pipeline.stack_preps(eager_preps(), BATCH),
                graphed_stack, 5, BATCH)
    say("prep_graph", case="audioapp_batch8", frames=BATCH,
        frames_bit_equal=frames_equal, tables_bit_equal=tables_equal,
        first_batch_ms=f"{batch_ms:.1f}", pool_reserved_bytes=pool,
        capture_peak_bytes=peak, per="batch of 8 (prep and stack)", **m,
        card=repr(smi))
    if not (frames_equal and tables_equal):
        fail("prep_graph: the graphed batch differs from the op-by-op preps")

    # A one-off frame of a new shape: op by op, no capture.
    frame_prep.PREP_GRAPH.clear()
    c0 = frame_prep.PREP_GRAPH.captures
    _, one_ms = wall_ms(lambda: pipeline.render_frame(
        scenes[0], cam, lights[0], cfg, displacement=0.05,
        shadow_target=target, device=dev))
    one_captures = frame_prep.PREP_GRAPH.captures - c0
    frame_prep.PREP_GRAPH.clear()
    c0 = frame_prep.PREP_GRAPH.captures
    # A session resized every frame through six sizes, three rounds: the
    # first round op by op, the second captures each size (freeing the
    # two oldest graphs), the third replays four and runs two op by op.
    sizes = [(W - 64 * k, H - 36 * k) for k in range(6)]
    sess = session.InteractiveSession(
        config=cfg, shadow_config=ShadowConfig(), device=dev)
    rounds = []
    for _ in range(3):
        ms = []
        for w, h in sizes:
            sess.handle_event({"type": "resize", "width": w, "height": h})
            _, t = wall_ms(sess.render_frame)
            ms.append(round(t, 2))
        rounds.append(ms)
    say("prep_graph", case="one_off_and_resizes", one_off_frame_ms=(
        f"{one_ms:.2f}"), one_off_captures=one_captures,
        resize_round_ms=json.dumps(rounds),
        session_captures=frame_prep.PREP_GRAPH.captures - c0,
        card=repr(smi))
    if one_captures or frame_prep.PREP_GRAPH.captures - c0 != len(sizes):
        fail("prep_graph: the resized session did not capture each size "
             "once")
    frame_prep.PREP_GRAPH.clear()


def frame_gaps(img, ref, tile=SWEEP_TILE):
    """(frame_mae, tile_mae) of an rgba frame f32[H, W, 4] against the
    reference's, as the benchmark's check computes them."""
    import torch
    d = torch.abs(img.float() - ref.float())
    tiles = torch.nn.functional.avg_pool2d(
        d.permute(2, 0, 1)[None], tile, ceil_mode=True).mean(dim=1)
    return float(d.mean()), float(tiles.max())


def sliver_probe(scene, cam, light, cfg, dev, smi):
    """Phase 26's first line: at SWEEP_FAULT, pixel SWEEP_PIXEL's winner
    (K1's winner plane on the frame's main bins), its screen vertices, area
    and per-vertex 1/w (the reference backend's setup, the same triangles),
    the 1/w plane evaluated at the sample as (a*sx + b*sy) + c, the 1/w
    that the edge weights give (the edge values anchored on the pixel, at
    least 0, normalized by their sum), and the pixel of both frames."""
    import torch
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import geometry, raster_cuda
    px, py = SWEEP_PIXEL
    samples = tuple(cfg.sample_positions)
    kw = dict(displacement=SWEEP_FAULT, device=dev)
    prep = pipeline.prepare_frame(scene, cam, light, cfg, **kw)
    _, win = raster_cuda.raster_depth(prep.main_bins, cfg.width, cfg.height,
                                      samples)
    tid = int(win[0, py, px])
    del prep, win
    s = pipeline.prepare_frame(scene, cam, light, cfg, backend="reference",
                               **kw).main_setup
    fb, _ = pipeline.render_frame(scene, cam, light, cfg, **kw)
    ref, _ = pipeline.render_frame(scene, cam, light, cfg,
                                   backend="reference", **kw)
    f32 = torch.float32
    offx, offy = samples[0]
    sx = torch.tensor(px, dtype=f32) + offx
    sy = torch.tensor(py, dtype=f32) + offy
    a, b, c = geometry.scalar_planes(s, s.inv_w)[tid].cpu()
    plane = (a * sx + b * sy) + c
    x, y = torch.tensor(px, dtype=f32), torch.tensor(py, dtype=f32)
    edge = s.edge[tid].cpu()
    e = [torch.clamp_min((edge[k, 0] * offx + edge[k, 1] * offy)
                         + ((edge[k, 2] + edge[k, 0] * x) + edge[k, 1] * y),
                         0.0) for k in range(3)]
    lam = torch.stack([e[1], e[2], e[0]]) / ((e[1] + e[2]) + e[0])
    iw = s.inv_w[tid].cpu()
    bounded = (lam[0] * iw[0] + lam[1] * iw[1]) + lam[2] * iw[2]
    scr = s.screen[tid].cpu()
    say("sphere_sweep", probe=f"displacement {SWEEP_FAULT!r}",
        pixel=f"({px}, {py})", tid=tid, valid=bool(s.valid[tid]),
        screen=json.dumps([[float(v) for v in p] for p in scr]),
        area_px2=float(1.0 / s.inv_area[tid]) if float(s.inv_area[tid]) > 0
        else 0.0,
        inv_w=json.dumps([float(v) for v in iw]),
        invw_plane=json.dumps([float(a), float(b), float(c)]),
        invw_by_plane=float(plane),
        edges_at_sample=json.dumps([float(v) for v in e]),
        weights=json.dumps([float(v) for v in lam]),
        invw_by_weights=float(bounded),
        rgba=json.dumps([float(v) for v in fb[py, px]]),
        reference_rgba=json.dumps([float(v) for v in ref[py, px]]),
        card=repr(smi))


def sphere_sweep_phase(dev, smi, n=SWEEP_N):
    """Phase 26: BASELINE config 5 at full size over SWEEP_FAULT and n
    displacements spread over [0, 0.05], through ``render_frame`` and
    ``render_batch`` (two frames a call), each frame held against the
    reference backend's at the sphere cells' limits; prints the frames
    beyond them, then the largest readings. Fails at the end if any frame
    is beyond a limit."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch import render_batch
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.passes import pipeline
    t_phase = time.perf_counter()
    scene, cam, light, cfg = configs.config5_animated_high_poly(
        target_tris=C5_TRIS, width=C5_W, height=C5_H, device=dev)
    sliver_probe(scene, cam, light, cfg, dev, smi)
    disps = [SWEEP_FAULT] + [float(d) for d in
                             np.linspace(0.0, 0.05, n).astype(np.float32)]
    worst = {p: {"frame_mae": (0.0, None), "tile_mae": (0.0, None)}
             for p in ("render_frame", "render_batch")}
    beyond, ref_ms = [], []
    for k in range(0, len(disps), 2):
        pair = disps[k:k + 2]
        rgba, _ = render_batch(scene, cam, light, pair, config=cfg,
                               device=dev)
        for j, d in enumerate(pair):
            fb, _ = pipeline.render_frame(scene, cam, light, cfg,
                                          displacement=d, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, _ = pipeline.render_frame(scene, cam, light, cfg,
                                           displacement=d,
                                           backend="reference", device=dev)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            for path, img in (("render_frame", fb), ("render_batch",
                                                      rgba[j])):
                fm, tm = frame_gaps(img, ref)
                for name, v in (("frame_mae", fm), ("tile_mae", tm)):
                    if not v <= worst[path][name][0]:
                        worst[path][name] = (v, d)
                if not (fm <= SWEEP_FRAME_MAE and tm <= SWEEP_TILE_MAE):
                    beyond.append((path, d))
                    say("sphere_sweep", beyond=path, displacement=repr(d),
                        frame_mae=fm, tile_mae=tm)
            del fb, ref
        del rgba
    for path, w in worst.items():
        say("sphere_sweep", path=path, frames=len(disps),
            max_frame_mae=w["frame_mae"][0],
            at=repr(w["frame_mae"][1]), max_tile_mae=w["tile_mae"][0],
            tile_at=repr(w["tile_mae"][1]), frame_mae_limit=SWEEP_FRAME_MAE,
            tile_mae_limit=SWEEP_TILE_MAE)
    say("sphere_sweep", frames_beyond=len(beyond),
        reference_ms=f"{statistics.median(ref_ms):.1f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))
    if beyond:
        fail(f"config 5: {len(beyond)} frames beyond the sphere cells' "
             f"limits: {beyond}")



def span_device_ms(fn, prefix="mr/prep"):
    """fn() once under torch.profiler: the device ms of the kernels and
    copies launched inside each span whose name starts with ``prefix``
    (the span's device_time_total: its own and its children's), and every
    device event's ms in the window."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    events = prof.events()
    for e in events:
        if e.name.startswith(prefix):
            out[e.name] += e.device_time_total / 1e3
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    return {k: round(v, 4) for k, v in sorted(out.items())}, total


def setup_kernel_phase(dev, smi):
    """Phase 27: the main pass's geometry front end on config 5 at full
    size (1M triangles, 3840x2160) and the flagship frame (1920x1080). Per
    case: the op-by-op prep's device ms by ``mr/prep/*`` span (the bake,
    the light pass, the main pass's front end, each pass's binning) under
    torch.profiler, beside every device event's ms; the prep graph's
    device ms a frame (its replays back to back, and with the host ahead)
    and its pool. Then the kernel (``raster/setup_cuda.py``,
    ``csrc/setup.cu``): its tables and stats against the plain chain's on
    the card (bit-equal), the kernel's device ms host ahead with the guard
    band off (the tables pass alone) and on (its three launches, the sort
    and the fan code between them), beside its byte bound and the plain
    chain's ms, and the launch counter over one op-by-op prep, one capture
    and a replay. Loaded by path with another checkout first on
    ``sys.path``, it measures that checkout's package, which needs the
    kernel and ``passes/prep.py``."""
    import gc

    import torch
    from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.math import transforms
    from metalrenderer_tpu_torch.passes import prep as frame_prep
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    from metalrenderer_tpu_torch.scene.scene import bake
    from metalrenderer_tpu_torch.raster import setup_cuda
    import metalrenderer_tpu_torch
    pkg = str(Path(metalrenderer_tpu_torch.__file__).parent)

    def captured(fn):
        """fn() captured as a CUDA graph (after a warm-up on a side
        stream): the graph's replay."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        keep.append(graph)
        return graph.replay

    keep = []
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    cases = (
        ("config5_4k", lambda: configs.config5_animated_high_poly(
            target_tris=C5_TRIS, width=C5_W, height=C5_H, device=dev),
         (0.0, 0.0, 0.0), 0.025, 5),
        ("flagship", lambda: (audio_app.build_scene(device=dev), cam,
                              Lighting(light=PointLight(),
                                       ambient_intensity=0.1,
                                       shininess=32.0),
                              RenderConfig(width=W, height=H, msaa=4,
                                           shadow_map_size=SHADOW)),
         (0.0, 0.0, -1.0), 0.05, 50))
    for name, build, target, disp, reps in cases:
        scene, cm, lt, cf = build()

        def eager():
            return frame_prep.prepare(scene, cm, lt, cf, ShadowConfig(),
                                      disp, target, dev, None, graphed=False)
        eager()
        spans, total = span_device_ms(eager)
        say("setup_kernel", case=name, package=pkg,
            eager_span_device_ms=json.dumps(spans),
            eager_device_ms=f"{total:.4f}", card=repr(smi))

        graphs = frame_prep.PREP_GRAPH
        graphs.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        setup_cuda.reset_launch_counts()
        c0, n0 = graphs.captures, graphs.replays
        r0 = torch.cuda.memory_reserved()
        for _ in range(3):      # op by op, capture, replay
            frame_prep.prepare(scene, cm, lt, cf, ShadowConfig(), disp,
                               target, dev, None, graphed=True)
        torch.cuda.synchronize()
        pool = torch.cuda.memory_reserved() - r0
        graph, = graphs.graphs.values()
        replay_ms, replay_dev_ms = timings(graph.graph.replay, reps)
        say("setup_kernel", case=name, graph_replay_ms=f"{replay_ms:.4f}",
            graph_replay_device_ms=f"{replay_dev_ms:.4f}",
            pool_reserved_bytes=pool, captures=graphs.captures - c0,
            replays=graphs.replays - n0,
            launches=json.dumps(setup_cuda.LAUNCHES), card=repr(smi))
        graphs.clear()

        geom = bake(scene, disp)
        vp = transforms.matmul(cm.projection_matrix(),
                               cm.view_matrix()).to(dev)
        n, cap = geom.num_triangles, min(cf.xyclip_capacity,
                                         2 * geom.num_triangles)
        equal = {}
        for guard, c in (("on", cf), ("off", cf.replace(xyclip_capacity=0))):
            got = setup_cuda.main_pass_tables(geom, vp, c)
            want = setup_cuda.main_pass_tables_plain(geom, vp, c)
            equal[guard] = all(
                torch.equal(getattr(got, k).reshape(-1).view(torch.uint8),
                            getattr(want, k).reshape(-1).view(torch.uint8))
                for k in ("vis", "attr", "aabb", "valid")) and all(
                got.stats[k].dtype == want.stats[k].dtype
                and torch.equal(got.stats[k].reshape(1).view(torch.uint8),
                                want.stats[k].reshape(1).view(torch.uint8))
                for k in want.stats) and list(got.stats) == list(want.stats)
        stats = {k: float(v) for k, v in want.stats.items()}
        del got, want
        slots_off = 2 * n
        read = 96 * n + 24 * n + 64
        bytes_off = read + slots_off * (4 * (17 + 48 + 4) + 1)
        # The keys written and read again, and the fan pieces' rows.
        bytes_on = bytes_off + 4 * n + 5 * cap * (4 * (17 + 48 + 4) + 1)
        # Each form captured as a CUDA graph, as the prep graph runs it,
        # and timed by its replays (allocation stays out of the window).
        k_off, k_on = (timings(captured(lambda c=c: setup_cuda.
                                        main_pass_tables(geom, vp, c)), reps)
                       for c in (cf.replace(xyclip_capacity=0), cf))
        plain_ms = cuda_ms(lambda: setup_cuda.main_pass_tables_plain(
            geom, vp, cf), max(1, reps // 5))
        say("setup_kernel", case=name, triangles=n, slots=2 * n + 5 * cap,
            bit_equal=json.dumps(equal), stats=json.dumps(stats),
            tables_ms=f"{k_off[0]:.4f}", tables_device_ms=f"{k_off[1]:.4f}",
            tables_bound_ms=f"{bytes_off / HBM_BYTES_PER_MS:.4f}",
            guarded_ms=f"{k_on[0]:.4f}", guarded_device_ms=f"{k_on[1]:.4f}",
            guarded_bound_ms=f"{bytes_on / HBM_BYTES_PER_MS:.4f}",
            bound_by="bytes", plain_ms=f"{plain_ms:.4f}", card=repr(smi))
        if not all(equal.values()):
            fail(f"setup_kernel: {name}'s kernel tables differ from the "
                 "plain chain's")
        del geom, scene
        keep.clear()
        gc.collect()
        torch.cuda.empty_cache()


def track_kernel_phase(dev, smi, stats):
    """Phase 20's first part: the audio track's carries kernels
    (``audio/track_cuda.py``, kernel ``csrc/track.cu``) called through
    ``analyzer.carries`` and ``mapping.envelope`` on the card at 1, 8 and
    32 chunks a call (the live cell's, the stream cell's and phase 20's
    shapes), from seeded analyzer states with the ring empty, filling, one
    short of full, full and about to wrap: each call's new state, carried
    values and envelope bit-equal to the numpy twins' (``analyzer._carries``
    and ``mapping._envelope``, what the CPU runs), one launch of each kernel
    a call. At 1 and 8 chunks each kernel's ms (back to back), device ms
    (host ahead), its twin's host ms and its bound. Sets
    ``stats["track_carries"]`` and ``stats["track_envelope"]`` to the
    1-chunk numbers (the live cell's call); returns the 8-chunk rows."""
    import numpy as np
    import torch
    from metalrenderer_tpu_torch.audio import analyzer, mapping, track_cuda
    f32 = np.float32
    win = analyzer.ROLLING_WINDOW
    rng = np.random.default_rng(20)

    def bits(t):
        return t.cpu().contiguous().reshape(-1).view(torch.int32)

    def same(a, b):
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    def mean_host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    rows = []
    for n in (1, 8, 32):
        equal = {"carries": True, "envelope": True}
        for count, idx in ((0, 0), (37, 0), (win - 1, 0), (win, 0),
                           (win, win - 1)):
            state = analyzer.AnalyzerState(
                rolling=torch.from_numpy(rng.random(win, dtype=f32)
                                         * f32(0.01)),
                rolling_idx=torch.tensor(idx, dtype=torch.int32),
                rolling_count=torch.tensor(count, dtype=torch.int32),
                rolling_sum=torch.tensor(rng.random(dtype=f32) * f32(0.5)),
                smoothed_bass=torch.tensor(rng.random(dtype=f32)),
                smoothed_mid=torch.tensor(rng.random(dtype=f32)),
                smoothed_treble=torch.tensor(rng.random(dtype=f32)))
            vec = state.pack()
            scalars = torch.from_numpy(rng.random((n, 4), dtype=f32)
                                       * f32(0.02))
            raw = torch.from_numpy(rng.random(n, dtype=f32))
            raw[::3] = 0.0                 # decays between the peaks
            start = torch.from_numpy(rng.random(1, dtype=f32))
            track_cuda.reset_launch_counts()
            got_vec, got_carried = analyzer.carries(vec.to(dev),
                                                    scalars.to(dev))
            got_env = mapping.envelope(start.to(dev), raw.to(dev))
            torch.cuda.synchronize()
            launches = dict(track_cuda.LAUNCHES)
            want, avg, smoothed = analyzer._carries(
                state, scalars[:, 0].numpy(), scalars[:, 1:].numpy())
            equal["carries"] &= (
                same(got_vec, want.pack())
                and same(got_carried[:, 0], torch.from_numpy(avg))
                and same(got_carried[:, 1:], torch.from_numpy(smoothed)))
            equal["envelope"] &= same(got_env[:1], start) and same(
                got_env[1:],
                torch.from_numpy(mapping._envelope(float(start[0]),
                                                   raw.numpy())))
            if launches != {"track_carries": 1, "track_envelope": 1}:
                fail(f"track kernels at {n} chunks: launch counts "
                     f"{launches}, want one of each")
        say("track_kernels", chunks=n, rings=5,
            bit_equal=json.dumps(equal), card=repr(smi))
        if not all(equal.values()):
            fail(f"track kernels at {n} chunks differ from their numpy "
                 f"twins: {equal}")
        if n == 32:
            continue
        vec_d, sc_d = vec.to(dev), scalars.to(dev)
        start_d, raw_d = start.to(dev), raw.to(dev)
        alpha, keep = float(analyzer._ALPHA), float(analyzer._KEEP)
        decay = float(mapping._DECAY)
        rms_np, bands_np = scalars[:, 0].numpy(), scalars[:, 1:].numpy()
        raw_np = raw.numpy()
        # Each input read once, each output written once; the operations
        # a chunk: the average's division, the sum's add and subtract, the
        # three EMAs' two multiplies and an add (the envelope's: one
        # multiply and the max).
        cases = (
            ("track_carries",
             lambda: track_cuda.carries(vec_d, sc_d, alpha, keep),
             lambda: analyzer._carries(state, rms_np, bands_np),
             bound(2 * 4 * analyzer.STATE_LEN + 2 * 16 * n, 12 * n)),
            ("track_envelope",
             lambda: track_cuda.envelope(start_d, raw_d, decay),
             lambda: mapping._envelope(float(start[0]), raw_np),
             bound(4 + 4 * n + 4 * (n + 1), 2 * n)))
        for name, kernel, twin, bnd in cases:
            ms, dev_ms = timings(kernel, 200)
            plain = mean_host_ms(twin, 200)
            say("track_kernels", kernel=name, chunks=n, ms=f"{ms:.4f}",
                device_ms=f"{dev_ms:.4f}", plain_host_ms=f"{plain:.4f}",
                bound_ms=f"{bnd[0]:.3g}", bound_by=bnd[1], card=repr(smi))
            numbers = (0.0, ms, dev_ms, plain, bnd)
            if n == 1:
                stats[name] = numbers
            else:
                rows.append(kernel_row(
                    f"{name}@{n}_chunks", TRACK_SRC,
                    "audio/analyzer.py:223" if name == "track_carries"
                    else "audio/mapping.py:98", 1, *numbers))
    return rows


def main():
    import torch
    start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs, renderer
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
    ptxas = ptxas_summary(log)
    say("build", seconds=f"{build_s:.2f}", lib=_build.library_path().name,
        ptxas=json.dumps(ptxas),
        sass_instructions=json.dumps(sass_counts(_build.library_path())))

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
    # The flagship's shadow bins (short lists), a 4,000-triangle soup, and
    # crowded soups whose longest tile list outgrows a staging chunk: at
    # 1024^2 on the shadow pass's 64x128 tiles with a big list near its cap,
    # and at the ragged 1000x601 on 40x24 tiles, there also with 4 samples.
    # Each with and without the winner plane.
    k1_err = 0.0
    chunk = raster_cuda.FUSED_STAGING_CHUNK
    soup = soup_setup(4000, SHADOW, seed=7, device=dev)
    soup_bins = binning.bin_triangles(soup, binning.build_tri_fields(soup),
                                      SHADOW, SHADOW, 128, 64)
    crowd_bins = [fused_soup_bins(SHADOW, SHADOW, seed=sd, device=dev,
                                  big=280, tile_w=128, tile_h=64,
                                  big_extent=500.0) for sd in (3, 4)]
    ragged_bins = fused_soup_bins(1000, 601, seed=3, device=dev, tile_w=40,
                                  tile_h=24)
    for name, bins, w, h, smp in (
            ("flagship_shadow", prep.shadow_bins, SHADOW, SHADOW, center),
            ("soup4000", soup_bins, SHADOW, SHADOW, center),
            (f"crowd_{SHADOW}x{SHADOW}_64x128", crowd_bins[0], SHADOW,
             SHADOW, center),
            ("crowd_1000x601_40x24", ragged_bins, 1000, 601, center),
            ("crowd_1000x601_40x24_s4", ragged_bins, 1000, 601, samples)):
        d_k, w_k = raster_cuda.raster_depth(bins, w, h, smp)
        d_n, w_n = raster_cuda.raster_depth(bins, w, h, smp,
                                            with_winner=False)
        d_p, w_p = raster_cuda.raster_depth_plain(bins, w, h, smp)
        torch.cuda.synchronize()
        cnt = candidate_counts(bins)
        win_eq = torch.equal(w_k, w_p) and w_n is None
        bits_eq = all(torch.equal(d.view(torch.int32), d_p.view(torch.int32))
                      for d in (d_k, d_n))
        k1_err = max(k1_err, float((d_k - d_p).abs().max()),
                     float((d_n - d_p).abs().max()))
        covered = int((w_k >= 0).sum())
        over = int((cnt > chunk).sum())
        big_n, cap = int(bins.big_n[0]), bins.big_ids.shape[0]
        say("k1", case=name, samples=len(smp), covered=covered, big_n=big_n,
            big_cap=cap, big_dropped=int(bins.num_big_dropped),
            max_candidates=int(cnt.max()), staging_chunk=chunk,
            tiles_over_chunk=over, winners_equal=win_eq,
            depth_bit_equal=bits_eq)
        if not (win_eq and bits_eq):
            fail(f"K1 disagrees with its twin on {name}")
        if covered == 0:
            fail(f"K1 covered nothing on {name}")
        if name.startswith("crowd") and over == 0:
            fail(f"{name}: no tile list longer than a chunk")
        if name.startswith(f"crowd_{SHADOW}") and \
                not 7 * cap <= 8 * big_n <= 8 * cap:
            fail(f"{name}: big list {big_n} not near its cap {cap}")
        del d_k, w_k, d_n, d_p, w_p
    # The shadow path asks for depth alone: that form is K1's row, the
    # winner-carrying form beside it, each with its own byte bound.
    sb = prep.shadow_bins
    k1_ms, k1_dev = timings(lambda: raster_cuda.raster_depth(
        sb, SHADOW, SHADOW, center, with_winner=False), 200)
    k1w_ms, k1w_dev = timings(lambda: raster_cuda.raster_depth(
        sb, SHADOW, SHADOW, center), 200)
    _, k1_soup_dev = timings(lambda: raster_cuda.raster_depth(
        soup_bins, SHADOW, SHADOW, center, with_winner=False), 100)
    # The floor under K1's time: the same map with no candidate in any tile
    # (stores of the clear depth, the launch and the blocks' setup).
    empty = dataclasses.replace(sb, tile_offsets=torch.zeros_like(
        sb.tile_offsets), big_n=torch.zeros_like(sb.big_n))
    _, k1_empty_dev = timings(lambda: raster_cuda.raster_depth(
        empty, SHADOW, SHADOW, center, with_winner=False), 200)
    k1_plain_ms = cuda_ms(lambda: raster_cuda.raster_depth_plain(
        sb, SHADOW, SHADOW, center, with_winner=False), 5)
    plane_bytes = SHADOW * SHADOW * 4
    k1_ops = raster_ops(sb, SHADOW, SHADOW, 1)
    k1_bound = bound(bins_bytes(sb, False) + plane_bytes, k1_ops)
    k1w_bound = bound(bins_bytes(sb, False) + 2 * plane_bytes, k1_ops)
    say("k1", shape=f"{SHADOW}x{SHADOW}x1", form="depth_only",
        ms=f"{k1_ms:.4f}", device_ms=f"{k1_dev:.5f}",
        plain_ms=f"{k1_plain_ms:.4f}", bound_ms=f"{k1_bound[0]:.5f}",
        bound_by=k1_bound[1], with_winner_ms=f"{k1w_ms:.4f}",
        with_winner_device_ms=f"{k1w_dev:.5f}",
        with_winner_bound_ms=f"{k1w_bound[0]:.5f}",
        soup4000_device_ms=f"{k1_soup_dev:.5f}",
        empty_map_device_ms=f"{k1_empty_dev:.5f}",
        parts=raster_cuda._depth_parts(sb, 1), card=repr(smi))
    stats["raster_depth"] = (k1_err, k1_ms, k1_dev, k1_plain_ms, k1_bound,
                             None, None)

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
    # Seeded soups: the flagship's tile lists are empty (all 15 candidates
    # come from the big list), so here K2 walks lists, one longer than a
    # staging chunk, a big list near its cap and z-fighting pairs; at a
    # ragged size; and on a tile shape other than 8x128.
    chunk = raster_cuda.FUSED_STAGING_CHUNK
    for name, w, h, tw, th in ((f"soup_{W}x{H}_8x128", W, H, 128, 8),
                               ("soup_1000x601_8x128", 1000, 601, 128, 8),
                               ("soup_1000x601_40x24", 1000, 601, 40, 24)):
        sbins = fused_soup_bins(w, h, seed=3, device=dev, tile_w=tw,
                                tile_h=th)
        cnt = candidate_counts(sbins)
        lists = sbins.tile_offsets[1:] - sbins.tile_offsets[:-1]
        r_k, c_k = raster_cuda.render_fused(sbins, uni, shadow_map, w, h,
                                            samples)
        r_p, c_p = raster_cuda.render_fused_plain(sbins, uni, shadow_map, w,
                                                  h, samples)
        torch.cuda.synchronize()
        err = float((r_k - r_p).abs().max())
        eq = torch.equal(c_k, c_p)
        over = int((cnt > chunk).sum())
        big_n, cap = int(sbins.big_n[0]), sbins.big_ids.shape[0]
        say("k2", case=name, triangles=sbins.vis.shape[0],
            tiles_with_list=int((lists > 0).sum()), max_list=int(lists.max()),
            big_n=big_n, big_cap=cap, big_dropped=int(sbins.num_big_dropped),
            max_candidates=int(cnt.max()), staging_chunk=chunk,
            tiles_over_chunk=over, covered_px=int((c_k > 0).sum()),
            covf_equal=eq, rgba_max_abs_err=err, tol=1e-5)
        if not eq or not err <= 1e-5:
            fail(f"K2 disagrees with its twin on {name}")
        k2_err = max(k2_err, err)
        if (tw, th) == (128, 8) and not (int(lists.max()) > 0 and over > 0):
            fail(f"{name}: no tile list, or none longer than a chunk")
        if (w, h) == (W, H) and not 7 * cap <= 8 * big_n <= 8 * cap:
            fail(f"{name}: big list {big_n} not near its cap {cap}")
        if (w, h, tw) == (W, H, 128):
            soup_ms, soup_dev = timings(lambda: raster_cuda.render_fused(
                sbins, uni, shadow_map, w, h, samples), 100)
        del sbins, r_k, c_k, r_p, c_p
    # A soup whose centre tile holds ~12,000 candidates (duplicates and
    # z-fights among them): the split walk, its items merged per sample.
    crowds = [fused_soup_bins(W, H, seed=sd, device=dev, crowd=10000)
              for sd in (5, 6)]
    crowd = crowds[0]
    r_k, c_k = raster_cuda.render_fused(crowd, uni, shadow_map, W, H,
                                        samples)
    r_p, c_p = raster_cuda.render_fused_plain(crowd, uni, shadow_map, W, H,
                                              samples)
    torch.cuda.synchronize()
    err = float((r_k - r_p).abs().max())
    eq = torch.equal(c_k, c_p)
    cnt = candidate_counts(crowd)
    say("k2", case="crowd10k_1920x1080_8x128", triangles=crowd.vis.shape[0],
        max_candidates=int(cnt.max()), covered_px=int((c_k > 0).sum()),
        covf_equal=eq, rgba_max_abs_err=err, tol=1e-5)
    st = split_line("k2_crowd10k", crowd, len(samples),
                    lambda: raster_cuda.render_fused(crowd, uni, shadow_map,
                                                     W, H, samples))
    if not eq or not err <= 1e-5:
        fail("K2 disagrees with its twin on the crowd10k soup")
    if int(cnt.max()) < 9000 or st["split_tiles"] == 0:
        fail("crowd10k: no tile of ~10,000 candidates, or none split")
    k2_err = max(k2_err, err)
    del r_k, c_k, r_p, c_p
    k2_ms, k2_dev = timings(lambda: raster_cuda.render_fused(
        mb, uni, shadow_map, W, H, samples), 100)
    k2_plain_ms = cuda_ms(lambda: raster_cuda.render_fused_plain(
        mb, uni, shadow_map, W, H, samples), 3)
    k2_ops = raster_ops(mb, W, H, len(samples), int((covf_k > 0).sum()))
    k2_bound = bound(
        bins_bytes(mb, True) + nbytes(uni, shadow_map, rgba_k, covf_k), k2_ops)
    say("k2", ms=f"{k2_ms:.4f}", device_ms=f"{k2_dev:.5f}",
        plain_ms=f"{k2_plain_ms:.4f}", bound_ms=f"{k2_bound[0]:.5f}",
        bound_by=k2_bound[1], ops_bound_ms=f"{k2_ops / FP32_OPS_PER_MS:.5f}",
        soup_1920x1080_ms=f"{soup_ms:.4f}",
        soup_1920x1080_device_ms=f"{soup_dev:.5f}", card=repr(smi))
    stats["render_fused"] = (k2_err, k2_ms, k2_dev, k2_plain_ms, k2_bound,
                             None, None)

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
    serve_med = med

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
    # Phase 3's seeded soups: config 4's tile lists are short, so here K3
    # walks lists longer than a staging chunk, a big list near its cap and
    # z-fighting pairs, at a ragged size and on 40x24 tiles; the per-sample
    # planes on the last.
    chunk = raster_cuda.FUSED_STAGING_CHUNK
    for name, w, h, tw, th in ((f"soup_{W}x{H}_8x128", W, H, 128, 8),
                               ("soup_1000x601_8x128", 1000, 601, 128, 8),
                               ("soup_1000x601_40x24", 1000, 601, 40, 24)):
        sbins = fused_soup_bins(w, h, seed=3, device=dev, tile_w=tw,
                                tile_h=th)
        with_s = th == 24
        o_k = raster_cuda.raster_gbuffer(sbins, w, h, samples,
                                         with_samples=with_s)
        o_p = raster_cuda.raster_gbuffer_plain(sbins, w, h, samples,
                                               with_samples=with_s)
        torch.cuda.synchronize()
        eq = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(o_k, o_p) if a is not None)
        err = float((o_k[0] - o_p[0]).abs().max())
        cnt = candidate_counts(sbins)
        covered = int((o_k[0][binning.ROW_DEPTH] > 0).sum())
        say("k3", case=name, triangles=sbins.vis.shape[0],
            big_n=int(sbins.big_n[0]), max_candidates=int(cnt.max()),
            staging_chunk=chunk, tiles_over_chunk=int((cnt > chunk).sum()),
            covered_px=covered, with_samples=with_s, bit_equal=eq,
            max_abs_err=err)
        if not eq:
            fail(f"K3 disagrees with its twin on {name}")
        if covered == 0 or (th == 8 and int((cnt > chunk).sum()) == 0):
            fail(f"{name}: K3 covered nothing, or no list outgrew a chunk")
        k3_err = max(k3_err, err)
        if (w, h) == (W, H):
            k3_soup_ms, k3_soup_dev = timings(lambda: raster_cuda.raster_gbuffer(
                sbins, w, h, samples), 100)
            k3_soup_bound = bound(
                bins_bytes(sbins, True) + nbytes(o_k[0]),
                raster_ops(sbins, w, h, len(samples), covered))
        del sbins, o_k, o_p
    # Phase 3's crowd10k soup: the split walk, per-sample planes included.
    o_k = raster_cuda.raster_gbuffer(crowd, W, H, samples, with_samples=True)
    o_p = raster_cuda.raster_gbuffer_plain(crowd, W, H, samples,
                                           with_samples=True)
    torch.cuda.synchronize()
    eq = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
             for a, b in zip(o_k, o_p))
    say("k3", case="crowd10k_1920x1080_8x128",
        max_candidates=int(candidate_counts(crowd).max()),
        covered_px=int((o_k[0][binning.ROW_DEPTH] > 0).sum()),
        with_samples=True, bit_equal=eq,
        max_abs_err=float((o_k[0] - o_p[0]).abs().max()))
    if not eq:
        fail("K3 disagrees with its twin on the crowd10k soup")
    del o_k, o_p
    k3_ms, k3_dev = timings(lambda: raster_cuda.raster_gbuffer(
        mb4, W, H, samples), 100)
    k3_plain_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_plain(
        mb4, W, H, samples), 3)
    k3_ops = raster_ops(mb4, W, H, len(samples), covered4)
    k3_bound = bound(bins_bytes(mb4, True) + nbytes(gout_k), k3_ops)
    say("k3", ms=f"{k3_ms:.4f}", device_ms=f"{k3_dev:.5f}",
        plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound[0]:.5f}",
        bound_by=k3_bound[1], ops_bound_ms=f"{k3_ops / FP32_OPS_PER_MS:.5f}",
        soup_1920x1080_ms=f"{k3_soup_ms:.4f}",
        soup_1920x1080_device_ms=f"{k3_soup_dev:.5f}",
        soup_1920x1080_bound_ms=f"{k3_soup_bound[0]:.5f}",
        soup_1920x1080_bound_by=k3_soup_bound[1], card=repr(smi))
    stats["raster_gbuffer"] = (k3_err, k3_ms, k3_dev, k3_plain_ms, k3_bound,
                               None, None)

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
        grid=f"{W}x{H}", sampled_px=sampled7, max_abs_err=k7_err, tol=0,
        ptxas=repr(ptxas.get("sample_bilinear_kernel")))
    if not k7_err == 0.0 or sampled7 == 0:
        fail("K7 disagrees with its twin (or sampled nothing)")
    # The same lookup with no pixel sampled (the launch's fixed cost), and
    # on views of its planes that start 4, 8 and 12 bytes past a 16-byte
    # boundary (out of phase with the output: the kernel's scalar path),
    # each bit-equal to the twin.
    none7 = torch.zeros_like(smask)
    flat = [torch.cat([a.new_zeros(3), a.reshape(-1)])
            for a in (su, sv, smask)]
    views7 = [("no_pixel_sampled", (su, sv, none7))] + [
        (f"view_at_{4 * k}_bytes", tuple(a[k:k + su.numel()] for a in flat))
        for k in (1, 2, 3)]
    for name, (uu, vv, mm) in views7:
        o_k = sample_cuda.sample_bilinear(smap4, uu, vv, sampling.REPEAT,
                                          1.0, mm)
        o_p = sample_cuda.sample_bilinear_plain(smap4, uu, vv,
                                                sampling.REPEAT, 1.0, mm)
        torch.cuda.synchronize()
        eq = torch.equal(o_k.view(torch.int32), o_p.view(torch.int32))
        say("k7", case=name, u_offset_mod_16=uu.data_ptr() % 16,
            sampled_px=int(mm.sum()), bit_equal=eq)
        if not eq:
            fail(f"K7 disagrees with its twin on {name}")
    del flat, views7, o_k, o_p
    k7_ms, k7_dev = timings(lambda: sample_cuda.sample_bilinear(
        smap4, su, sv, sampling.REPEAT, 1.0, smask), 200)
    _, k7_none_dev = timings(lambda: sample_cuda.sample_bilinear(
        smap4, su, sv, sampling.REPEAT, 1.0, none7), 200)
    k7_plain_ms = cuda_ms(lambda: sample_cuda.sample_bilinear_plain(
        smap4, su, sv, sampling.REPEAT, 1.0, smask), 20)
    grid_sample = wrapped_grid_sample(smap4[None], su[None], sv[None])
    lib_err = float((grid_sample()[0, 0] - d_k).abs()[smask].max())
    k7_lib_ms, k7_lib_dev = timings(grid_sample, 200)
    # u and v are read only where the mask is set: 8 bytes per sampled px.
    k7_bound = bound(nbytes(smap4, smask, d_k) + 8 * sampled7,
                     18 * sampled7)
    # With no pixel sampled the launch reads the mask and writes out.
    k7_none_bound = bound(nbytes(smask, d_k), 0)
    say("k7", ms=f"{k7_ms:.4f}", device_ms=f"{k7_dev:.5f}",
        plain_ms=f"{k7_plain_ms:.4f}", library_ms=f"{k7_lib_ms:.4f}",
        library_device_ms=f"{k7_lib_dev:.5f}", library_max_abs_err=lib_err,
        bound_ms=f"{k7_bound[0]:.5f}", bound_by=k7_bound[1],
        no_pixel_sampled_device_ms=f"{k7_none_dev:.5f}",
        no_pixel_sampled_bound_ms=f"{k7_none_bound[0]:.5f}", card=repr(smi))
    stats["sample_bilinear"] = (k7_err, k7_ms, k7_dev, k7_plain_ms, k7_bound,
                                k7_lib_ms, k7_lib_dev)
    del none7

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
    k9_ms, k9_dev = timings(lambda: mip_cuda.sample_pyramid(*args9), 200)
    k9_plain_ms = cuda_ms(lambda: mip_cuda.sample_pyramid_plain(*args9), 20)
    pyr9, mask9 = args9[0], args9[4]
    k9_bound = bound(nbytes(pyr9.texels, mask9, *out9) + 12 * sampled9,
                     94 * sampled9)
    k9_grass_ms, k9_grass_dev = timings(
        lambda: mip_cuda.sample_pyramid(*cases9[1][1]), 200)
    say("k9", case="config4_normal_map", ms=f"{k9_ms:.4f}",
        device_ms=f"{k9_dev:.5f}", plain_ms=f"{k9_plain_ms:.4f}",
        bound_ms=f"{k9_bound[0]:.5f}", bound_by=k9_bound[1],
        grass_cube_color_ms=f"{k9_grass_ms:.4f}",
        grass_cube_color_device_ms=f"{k9_grass_dev:.5f}", card=repr(smi))
    stats["sample_pyramid"] = (k9_err, k9_ms, k9_dev, k9_plain_ms, k9_bound,
                               None, None)

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
    # And a 2-frame batch of phase 2's crowded soups (lists past a chunk,
    # big lists near their cap). Each batch with and without the winner
    # plane, against its twin and against per-frame K1 launches.
    cb2 = raster_cuda.stack_bins(crowd_bins)
    k4_err = 0.0
    for name, bins, per_frame in (("flagship_shadow8", sb8,
                                   [p.shadow_bins for p in preps8]),
                                  ("crowd2", cb2, crowd_bins)):
        d_k, w_k = raster_cuda.raster_depth_batch(bins, SHADOW, SHADOW,
                                                  center)
        d_n, w_n = raster_cuda.raster_depth_batch(bins, SHADOW, SHADOW,
                                                  center, with_winner=False)
        d_p, w_p = raster_cuda.raster_depth_batch_plain(bins, SHADOW, SHADOW,
                                                        center)
        k1_eq = True
        for f, b in enumerate(per_frame):
            d1, w1 = raster_cuda.raster_depth(b, SHADOW, SHADOW, center)
            k1_eq &= (torch.equal(d1.view(torch.int32),
                                  d_k[f].view(torch.int32))
                      and torch.equal(w1, w_k[f]))
        torch.cuda.synchronize()
        win_eq = torch.equal(w_k, w_p) and w_n is None
        bits_eq = all(torch.equal(d.view(torch.int32), d_p.view(torch.int32))
                      for d in (d_k, d_n))
        k4_err = max(k4_err, float((d_k - d_p).abs().max()),
                     float((d_n - d_p).abs().max()))
        say("k4", case=name, frames=len(per_frame),
            shape=f"{len(per_frame)}x{SHADOW}x{SHADOW}x1",
            covered=int((w_k >= 0).sum()), big_n=bins.big_n.tolist(),
            winners_equal=win_eq, depth_bit_equal=bits_eq,
            equal_to_k1=k1_eq)
        if not (win_eq and bits_eq and k1_eq):
            fail(f"K4 disagrees with its twin or with K1 on {name}")
    del d_k, w_k, d_n, d_p, w_p
    # The shadow path's form (depth alone) is K4's row; the winner-carrying
    # form beside it, each with its own byte bound.
    k4_ms, k4_dev = timings(lambda: raster_cuda.raster_depth_batch(
        sb8, SHADOW, SHADOW, center, with_winner=False), 100)
    k4w_ms, k4w_dev = timings(lambda: raster_cuda.raster_depth_batch(
        sb8, SHADOW, SHADOW, center), 100)
    k4_plain_ms = cuda_ms(lambda: raster_cuda.raster_depth_batch_plain(
        sb8, SHADOW, SHADOW, center, with_winner=False), 2)
    k4_ops = sum(raster_ops(raster_cuda.frame_bins(sb8, f), SHADOW, SHADOW, 1)
                 for f in range(BATCH))
    k4_bound = bound(bins_bytes(sb8, False) + BATCH * plane_bytes, k4_ops)
    k4w_bound = bound(bins_bytes(sb8, False) + 2 * BATCH * plane_bytes,
                      k4_ops)
    say("k4", form="depth_only", ms=f"{k4_ms:.4f}",
        device_ms=f"{k4_dev:.5f}", plain_ms=f"{k4_plain_ms:.4f}",
        per_frame_ms=f"{k4_ms / BATCH:.4f}", bound_ms=f"{k4_bound[0]:.5f}",
        bound_by=k4_bound[1], with_winner_ms=f"{k4w_ms:.4f}",
        with_winner_device_ms=f"{k4w_dev:.5f}",
        with_winner_bound_ms=f"{k4w_bound[0]:.5f}",
        parts=raster_cuda._depth_parts(sb8, BATCH), card=repr(smi))
    stats["raster_depth_batch"] = (k4_err, k4_ms, k4_dev, k4_plain_ms,
                                   k4_bound, None, None)

    # 13. K6 against its twin: that batch's main passes -----------------------
    mb8 = raster_cuda.stack_bins([p.main_bins for p in preps8])
    uni8 = torch.stack([p.uniforms for p in preps8])
    smaps8 = raster_cuda.raster_depth_batch(sb8, SHADOW, SHADOW, center,
                                            with_winner=False)[0][:, 0]
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
    # Two of phase 3's soups as one batch: lists longer than a chunk in
    # both frames; and its two crowd10k soups (the split walk in both).
    for case, soups in (
            ("soup_2x1920x1080_8x128",
             [fused_soup_bins(W, H, seed=s, device=dev) for s in (11, 12)]),
            ("crowd10k_2x1920x1080_8x128", crowds)):
        sb2 = raster_cuda.stack_bins(soups)
        args2 = (sb2, uni8[:2].contiguous(), smaps8[:2].contiguous(), W, H,
                 samples)
        r2k, c2k = raster_cuda.render_fused_batch(*args2)
        r2p, c2p = raster_cuda.render_fused_batch_plain(*args2)
        soup_k2_eq = True
        for f, sbins in enumerate(soups):
            r2, c2 = raster_cuda.render_fused(sbins, uni8[f], smaps8[f], W,
                                              H, samples)
            soup_k2_eq &= torch.equal(r2, r2k[f]) and torch.equal(c2, c2k[f])
        torch.cuda.synchronize()
        soup_err = float((r2k - r2p).abs().max())
        soup_eq = torch.equal(c2k, c2p)
        over = [int((candidate_counts(s)
                     > raster_cuda.FUSED_STAGING_CHUNK).sum()) for s in soups]
        say("k6", case=case, big_n=sb2.big_n.tolist(), tiles_over_chunk=over,
            split=raster_cuda.split_stats(sb2, len(samples)),
            covf_equal=soup_eq, rgba_max_abs_err=soup_err, tol=1e-5,
            equal_to_k2=soup_k2_eq)
        if not (soup_eq and soup_err <= 1e-5 and soup_k2_eq) or \
                min(over) == 0:
            fail(f"K6 disagrees with its twin or with K2 on {case} (or no "
                 "list outgrew a chunk)")
        k6_err = max(k6_err, soup_err)
        del soups, sb2, args2, r2k, c2k, r2p, c2p
    k6_ms, k6_dev = timings(lambda: raster_cuda.render_fused_batch(
        mb8, uni8, smaps8, W, H, samples), 50)
    k6_plain_ms = cuda_ms(lambda: raster_cuda.render_fused_batch_plain(
        mb8, uni8, smaps8, W, H, samples), 1)
    k6_ops = sum(raster_ops(raster_cuda.frame_bins(mb8, f), W, H,
                            len(samples), covered6[f]) for f in range(BATCH))
    k6_bound = bound(
        bins_bytes(mb8, True) + nbytes(uni8, smaps8, r_k, c_k), k6_ops)
    say("k6", ms=f"{k6_ms:.4f}", device_ms=f"{k6_dev:.5f}",
        plain_ms=f"{k6_plain_ms:.4f}", per_frame_ms=f"{k6_ms / BATCH:.4f}",
        bound_ms=f"{k6_bound[0]:.5f}", bound_by=k6_bound[1],
        ops_bound_ms=f"{k6_ops / FP32_OPS_PER_MS:.5f}", card=repr(smi))
    stats["render_fused_batch"] = (k6_err, k6_ms, k6_dev, k6_plain_ms,
                                   k6_bound, None, None)
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
    # Phase 13's two soups as one batch: lists longer than a chunk in both
    # frames; and its two crowd10k soups (the split walk in both).
    for case, soups in (
            ("soup_2x1920x1080_8x128",
             [fused_soup_bins(W, H, seed=s, device=dev) for s in (11, 12)]),
            ("crowd10k_2x1920x1080_8x128", crowds)):
        sb2 = raster_cuda.stack_bins(soups)
        g2k = raster_cuda.raster_gbuffer_batch(sb2, W, H, samples)
        g2p = raster_cuda.raster_gbuffer_batch_plain(sb2, W, H, samples)
        soup_k3_eq = True
        for f, sbins in enumerate(soups):
            g3 = raster_cuda.raster_gbuffer(sbins, W, H, samples)[0]
            soup_k3_eq &= torch.equal(g3.view(torch.int32),
                                      g2k[f].view(torch.int32))
        torch.cuda.synchronize()
        soup_eq = torch.equal(g2k.view(torch.int32), g2p.view(torch.int32))
        soup_err = float((g2k - g2p).abs().max())
        over = [int((candidate_counts(s)
                     > raster_cuda.FUSED_STAGING_CHUNK).sum()) for s in soups]
        say("k5", case=case, big_n=sb2.big_n.tolist(), tiles_over_chunk=over,
            covered_px=[int((g2k[f, binning.ROW_DEPTH] > 0).sum())
                        for f in range(2)],
            gout_bit_equal=soup_eq, equal_to_k3=soup_k3_eq,
            max_abs_err=soup_err)
        if not (soup_eq and soup_k3_eq) or min(over) == 0:
            fail(f"K5 disagrees with its twin or with K3 on {case} (or no "
                 "list outgrew a chunk)")
        k5_err = max(k5_err, soup_err)
        del soups, sb2, g2k, g2p, g3
    del crowds, crowd
    k5_ms, k5_dev = timings(lambda: raster_cuda.raster_gbuffer_batch(
        mb48, W, H, samples), 50)
    k5_plain_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_batch_plain(
        mb48, W, H, samples), 1)
    k5_ops = sum(raster_ops(raster_cuda.frame_bins(mb48, f), W, H,
                            len(samples), covered5[f]) for f in range(BATCH))
    k5_bound = bound(bins_bytes(mb48, True) + nbytes(g_k), k5_ops)
    say("k5", ms=f"{k5_ms:.4f}", device_ms=f"{k5_dev:.5f}",
        plain_ms=f"{k5_plain_ms:.4f}", per_frame_ms=f"{k5_ms / BATCH:.4f}",
        bound_ms=f"{k5_bound[0]:.5f}", bound_by=k5_bound[1],
        ops_bound_ms=f"{k5_ops / FP32_OPS_PER_MS:.5f}", card=repr(smi))
    stats["raster_gbuffer_batch"] = (k5_err, k5_ms, k5_dev, k5_plain_ms,
                                     k5_bound, None, None)

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
        tol=0, equal_to_k7=k7_eq,
        ptxas=repr(ptxas.get("sample_bilinear_kernel")))
    if not (k8_err == 0.0 and k7_eq) or sampled8 == 0:
        fail("K8 disagrees with its twin or with K7 (or sampled nothing)")
    # Frames of (H-1) x (W-1) pixels, an odd count: each frame's planes
    # start at another phase of the kernel's 8-pixel vectors.
    r_args = (smaps48, *(a[:, :H - 1, :W - 1].contiguous()
                         for a in (su, sv)), sampling.REPEAT, 1.0,
              smask[:, :H - 1, :W - 1].contiguous())
    r_k = sample_cuda.sample_bilinear_batch(*r_args)
    r_p = sample_cuda.sample_bilinear_batch_plain(*r_args)
    r_eq = torch.equal(r_k.view(torch.int32), r_p.view(torch.int32))
    r7_eq = all(torch.equal(sample_cuda.sample_bilinear(
        smaps48[f], r_args[1][f], r_args[2][f], sampling.REPEAT, 1.0,
        r_args[5][f]), r_k[f]) for f in range(BATCH))
    torch.cuda.synchronize()
    say("k8", case="ragged_frames", grid=f"{BATCH}x{W - 1}x{H - 1}",
        hw_mod_8=(H - 1) * (W - 1) % 8, sampled_px=int(r_args[5].sum()),
        bit_equal=r_eq, equal_to_k7=r7_eq)
    if not (r_eq and r7_eq):
        fail("K8 disagrees with its twin or with K7 on ragged frames")
    del r_args, r_k, r_p
    k8_ms, k8_dev = timings(lambda: sample_cuda.sample_bilinear_batch(
        *s_args), 100)
    k8_plain_ms = cuda_ms(lambda: sample_cuda.sample_bilinear_batch_plain(
        *s_args), 5)
    grid_sample = wrapped_grid_sample(smaps48, su, sv)
    lib_err = float((grid_sample()[:, 0] - s_k).abs()[smask].max())
    k8_lib_ms, k8_lib_dev = timings(grid_sample, 100)
    del grid_sample
    k8_bound = bound(nbytes(smaps48, smask, s_k) + 8 * sampled8,
                     18 * sampled8)
    say("k8", ms=f"{k8_ms:.4f}", device_ms=f"{k8_dev:.5f}",
        plain_ms=f"{k8_plain_ms:.4f}", per_frame_ms=f"{k8_ms / BATCH:.4f}",
        library_ms=f"{k8_lib_ms:.4f}", library_device_ms=f"{k8_lib_dev:.5f}",
        library_max_abs_err=lib_err, bound_ms=f"{k8_bound[0]:.5f}",
        bound_by=k8_bound[1], card=repr(smi))
    stats["sample_bilinear_batch"] = (k8_err, k8_ms, k8_dev, k8_plain_ms,
                                      k8_bound, k8_lib_ms, k8_lib_dev)
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
    batch_per_frame = {}
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
        batch_per_frame[name] = med / BATCH
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

    # 18. K3s against its twin ------------------------------------------------
    cfg4_t16 = cfg4.replace(tile_h=16)
    prep4_t16 = pipeline.prepare_frame(scene4, cam4, light4, cfg4_t16,
                                       device=dev)
    k3s_err = 0.0
    for name, bins in (("flagship_main_8x128", mb),
                       ("config4_main_16x128", prep4_t16.main_bins)):
        out_k = raster_cuda.raster_gbuffer_samples(bins, W, H, samples)
        out_p = raster_cuda.raster_gbuffer_samples_plain(bins, W, H, samples)
        torch.cuda.synchronize()
        (g_k, d_k, w_k), (g_p, d_p, w_p) = out_k, out_p
        win_eq = torch.equal(w_k, w_p)
        depth_eq = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
        gout_eq = torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
        row15_eq = torch.equal(g_k[:, binning.ROW_DEPTH], d_k)
        k3s_err = max(k3s_err, float((g_k - g_p).abs().max()))
        covered_s = int((w_k >= 0).sum())
        say("k3s", case=name, shape=f"{W}x{H}xS4",
            tiles=f"{bins.tile_h}x{bins.tile_w}", triangles=bins.vis.shape[0],
            big_n=int(bins.big_n[0]), gout_bytes=nbytes(g_k),
            covered_samples=covered_s, winners_equal=win_eq,
            depth_bit_equal=depth_eq, gout_bit_equal=gout_eq,
            row15_is_depth=row15_eq)
        if not (win_eq and depth_eq and gout_eq and row15_eq):
            fail(f"K3s disagrees with its twin on {name}")
        if covered_s == 0:
            fail(f"K3s covered nothing on {name}")
        if name.startswith("flagship"):
            k3s_bound = bound(bins_bytes(bins, True) + nbytes(g_k, d_k, w_k),
                              raster_ops(bins, W, H, len(samples), covered_s))
        del out_k, out_p, g_k, g_p, d_k, d_p, w_k, w_p
    k3s_ms, k3s_dev = timings(lambda: raster_cuda.raster_gbuffer_samples(
        mb, W, H, samples), 50)
    k3s_plain_ms = cuda_ms(lambda: raster_cuda.raster_gbuffer_samples_plain(
        mb, W, H, samples), 2)
    say("k3s", case="flagship_main_8x128", ms=f"{k3s_ms:.4f}",
        device_ms=f"{k3s_dev:.5f}", plain_ms=f"{k3s_plain_ms:.4f}",
        bound_ms=f"{k3s_bound[0]:.5f}", bound_by=k3s_bound[1],
        card=repr(smi))
    stats["raster_gbuffer_samples"] = (k3s_err, k3s_ms, k3s_dev, k3s_plain_ms,
                                       k3s_bound, None, None)

    # 19. serve supersampled frames (the per-sample branch) -------------------
    cfg_ss = cfg.replace(shading_per_pixel=False)
    target = (0.0, 0.0, -1.0)

    def frame_ss(d):
        return pipeline.render_frame(scene, cam, lighting, cfg_ss,
                                     displacement=d, shadow_target=target,
                                     device=dev)

    _, mem_ss = peak_mb(lambda: frame_ss(sdisps[0]))          # warm-up
    reset_counts()
    frame_ms, outs = timed_frames(frame_ss, sdisps)
    launches = read_counts()
    prep_ms, _ = timed_frames(lambda d: pipeline.prepare_frame(
        scene, cam, lighting, cfg_ss, displacement=d, shadow_target=target,
        device=dev), sdisps)
    # K7 at this path's lookup: one test per pixel, at the first covered
    # sample's world position.
    g_k, _, w_k = raster_cuda.raster_gbuffer_samples(mb, W, H, samples)
    ch = raster_cuda.channels_from_gout(g_k, w_k)
    w0, _ = shade._first_covered((ch["wx"], ch["wy"], ch["wz"]),
                                 ch["covered"])
    su, sv, _, inb = shade._shadow_coords(w0, uni[:16].reshape(4, 4))
    smask = inb & torch.any((ch["kind"] == BLINN_PHONG_SHADOW)
                            & ch["covered"], dim=0)
    k7ss_ms, k7ss_dev = timings(lambda: sample_cuda.sample_bilinear(
        shadow_map, su, sv, sampling.REPEAT, 1.0, smask), 200)
    del g_k, w_k, ch, w0, su, sv, inb, smask
    med = statistics.median(frame_ms)
    med_prep = statistics.median(prep_ms)
    finite = all(bool(torch.isfinite(fb).all()) for fb, _ in outs)
    shapes_ok = all(tuple(fb.shape) == (H, W, 4) for fb, _ in outs)
    covf_gpu = float(outs[-1][1]["covered_fraction"])
    fb_cpu, st_cpu = pipeline.render_frame(
        audio_app.build_scene(device="cpu"), cam, lighting, cfg_ss,
        displacement=sdisps[-1], shadow_target=target, device="cpu")
    covf_cpu = float(st_cpu["covered_fraction"])
    cpu_gpu_err = float((outs[-1][0].cpu() - fb_cpu).abs().max())
    kernels_ms = k1_ms + k3s_ms + k7ss_ms
    say("serve_ss", frames=BATCH, size=f"{W}x{H}", msaa=4, shadow=SHADOW,
        shading="per sample", median_ms=f"{med:.4f}",
        mpix_s=f"{W * H / med / 1e3:.3f}", min_ms=f"{min(frame_ms):.4f}",
        max_ms=f"{max(frame_ms):.4f}", peak_mem_mb=f"{mem_ss:.1f}",
        card=repr(smi))
    say("serve_ss", split="median ms", prep_ms=f"{med_prep:.4f}",
        k1_ms=f"{k1_ms:.4f}", k3s_ms=f"{k3s_ms:.4f}", k7_ms=f"{k7ss_ms:.4f}",
        k7_device_ms=f"{k7ss_dev:.5f}",
        rest_ms=f"{med - med_prep - kernels_ms:.4f}")
    say("serve_ss", launches=json.dumps(launches), finite=finite,
        shapes_ok=shapes_ok, covered_fraction_gpu=covf_gpu,
        covered_fraction_cpu=covf_cpu, rgba_max_abs_err_vs_cpu=cpu_gpu_err,
        tol=SS_RGBA_TOL)
    want = {k: 0 for k in launches}
    want.update(raster_depth=BATCH, raster_gbuffer_samples=BATCH,
                sample_bilinear=BATCH)
    if launches != want:
        fail(f"supersampled launch counts {launches} != {want}")
    if not (finite and shapes_ok):
        fail("non-finite or misshapen supersampled frames")
    if not abs(covf_gpu - covf_cpu) <= 1e-6:
        fail(f"supersampled covered_fraction {covf_gpu} (GPU) vs {covf_cpu} "
             "(CPU)")
    if not cpu_gpu_err <= SS_RGBA_TOL:
        fail(f"the supersampled frame on the card differs from the CPU run "
             f"by {cpu_gpu_err} > {SS_RGBA_TOL}")
    for k, n in launches.items():
        path_launches[k] += n
    prof = profile_frames(frame_ss, sdisps[:4])
    say("profile", path="flagship_supersampled", frames=4,
        **{k: f"{v:.4f}" for k, v in prof.items()}, card=repr(smi))
    del outs

    # Config 4 through the per-sample branch: every sample shaded, and
    # per-pixel shading on 16x128 tiles. Supersampled, K9 samples the
    # [4, H, W] sample planes in one launch: hold it against its twin there.
    g_k, _, w_k = raster_cuda.raster_gbuffer_samples(mb4, W, H, samples)
    ch4s = raster_cuda.channels_from_gout(g_k, w_k)
    del g_k, w_k
    mips4 = scene4.textures[0]
    args9s = (mip_cuda.build_pyramid(mips4), ch4s["u"], ch4s["v"],
              shade._texture_lod(ch4s["u"], ch4s["v"], mips4[0].shape[1],
                                 mips4[0].shape[0]),
              (ch4s["nmid"] == 0) & ch4s["covered"], sampling.REPEAT)
    k = mip_cuda.sample_pyramid(*args9s)
    p = mip_cuda.sample_pyramid_plain(*args9s)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    sampled = int(args9s[4].sum())
    k9s_ms, k9s_dev = timings(lambda: mip_cuda.sample_pyramid(*args9s), 50)
    say("k9", case="config4_normal_map_sample_planes",
        grid=f"{len(samples)}x{W}x{H}", sampled=sampled, max_abs_err=err,
        tol=0, ms=f"{k9s_ms:.4f}", device_ms=f"{k9s_dev:.5f}",
        card=repr(smi))
    if not err == 0.0 or sampled == 0:
        fail("K9 disagrees with its twin on config 4's sample planes (or "
             "sampled nothing)")
    stats["sample_pyramid"] = (max(err, stats["sample_pyramid"][0]),
                               *stats["sample_pyramid"][1:])
    del ch4s, args9s, k, p
    scene4_cpu = scene4.to("cpu")
    for name, c4 in (("config4_supersampled",
                      cfg4.replace(shading_per_pixel=False)),
                     ("config4_tile_h16", cfg4_t16)):
        reset_counts()
        (fb, st), mem = peak_mb(lambda: pipeline.render_frame(
            scene4, cam4, light4, c4, device=dev))
        launches = read_counts()
        fb_cpu, st_cpu = pipeline.render_frame(scene4_cpu, cam4, light4, c4,
                                               device="cpu")
        covf_gpu = float(st["covered_fraction"])
        covf_cpu = float(st_cpu["covered_fraction"])
        err = float((fb.cpu() - fb_cpu).abs().max())
        finite = bool(torch.isfinite(fb).all())
        say("serve_ss", path=name, launches=json.dumps(launches),
            finite=finite, covered_fraction_gpu=covf_gpu,
            covered_fraction_cpu=covf_cpu, rgba_max_abs_err_vs_cpu=err,
            tol=SS_RGBA_TOL, peak_mem_mb=f"{mem:.1f}")
        want = {k: 0 for k in launches}
        want.update(raster_depth=1, raster_gbuffer_samples=1,
                    sample_bilinear=1, sample_pyramid=2)
        if launches != want:
            fail(f"{name} launch counts {launches} != {want}")
        if not finite or tuple(fb.shape) != (H, W, 4):
            fail(f"{name}: non-finite or misshapen frame")
        if not abs(covf_gpu - covf_cpu) <= 1e-6:
            fail(f"{name} covered_fraction {covf_gpu} (GPU) vs {covf_cpu} "
                 "(CPU)")
        if not err <= SS_RGBA_TOL:
            fail(f"{name}: the card's frame differs from the CPU run by "
                 f"{err} > {SS_RGBA_TOL}")
        for k, n in launches.items():
            path_launches[k] += n
        del fb, st, fb_cpu

    # 20. the audio-reactive sequence ------------------------------------------
    track_rows = track_kernel_phase(dev, smi, stats)
    rate = 48000.0
    chunks = 32
    sig = audio_signal(chunks, seed=0, sample_rate=rate)

    def sequence(config=cfg, samples_=sig):
        return renderer.render_audio_reactive_sequence(
            samples_, rate, camera=cam, config=config, device=dev)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # Warm-up: op by op, then the track graph's capture.
    for _ in range(2):
        track = renderer.audio_visual_track(sig, rate, device=dev)
    _, track_ms = host_ms(lambda: renderer.audio_visual_track(
        sig, rate, device=dev))
    track_cpu = renderer.audio_visual_track(sig, rate, device="cpu")
    p_gpu, p_cpu = track[2], track_cpu[2]

    def rel_err(a, b):
        b = b.to(torch.float64)
        return float(((a.cpu().to(torch.float64) - b).abs()
                      / torch.clamp_min(b.abs(), 0.1)).max())

    err_int = rel_err(p_gpu.light_intensity, p_cpu.light_intensity)
    err_disp = rel_err(p_gpu.displacement, p_cpu.displacement)
    err_col = float((p_gpu.light_color.cpu() - p_cpu.light_color).abs().max())
    lag_eq = torch.equal(torch.round(rate / track[3].dominant_pitch.cpu()),
                         torch.round(rate / track_cpu[3].dominant_pitch))
    say("sequence", check="track vs CPU", chunks=chunks,
        light_intensity_rel_err=err_int, displacement_rel_err=err_disp,
        tol=1e-5, light_color_abs_err=err_col, color_tol=5e-5,
        best_lags_equal=lag_eq, track_ms=f"{track_ms:.4f}", card=repr(smi))
    if not (err_int <= 1e-5 and err_disp <= 1e-5 and err_col <= 5e-5
            and lag_eq):
        fail("the audio track on the card disagrees with the CPU run")

    sequence()                                        # warm-up
    reset_counts()
    ((frames, telem), seq_ms), mem_seq = peak_mb(lambda: host_ms(sequence))
    launches = read_counts()
    finite = bool(torch.isfinite(frames).all())
    shapes_ok = tuple(frames.shape) == (chunks, H, W, 4)
    distinct = float((frames[1] - frames[-1]).abs().max())
    say("sequence", path="fused_batch", frames=chunks, size=f"{W}x{H}",
        msaa=4, shadow=SHADOW, total_ms=f"{seq_ms:.4f}",
        track_ms=f"{track_ms:.4f}", render_ms=f"{seq_ms - track_ms:.4f}",
        per_frame_ms=f"{seq_ms / chunks:.4f}",
        mpix_s=f"{chunks * W * H / seq_ms / 1e3:.3f}",
        peak_mem_mb=f"{mem_seq:.1f}", card=repr(smi))
    say("sequence", path="fused_batch", launches=json.dumps(launches),
        finite=finite, shapes_ok=shapes_ok,
        telemetry_keys=sorted(telem), loud_vs_silent_max_abs_diff=distinct)
    # The track replays its graph (captured above): no carries launch.
    want = {k: 0 for k in launches}
    want.update(raster_depth_batch=1, render_fused_batch=1)
    if launches != want:
        fail(f"sequence launch counts {launches} != {want}")
    if not (finite and shapes_ok) or distinct == 0.0:
        fail("sequence frames non-finite, misshapen or not audio-reactive")
    for k, n in launches.items():
        path_launches[k] += n

    reset_counts()
    (streamed, stream_ms), mem_stream = peak_mb(lambda: host_ms(
        lambda: torch.cat([f for f, _ in renderer.stream_audio_reactive(
            sig, rate, chunk_frames=16, camera=cam, config=cfg,
            device=dev)])))
    launches = read_counts()
    stream_err = float((streamed - frames).abs().max())
    say("sequence", path="stream", chunk_frames=16,
        total_ms=f"{stream_ms:.4f}", per_frame_ms=f"{stream_ms / chunks:.4f}",
        launches=json.dumps(launches),
        max_abs_diff_vs_offline=stream_err, tol=1e-5,
        peak_mem_mb=f"{mem_stream:.1f}", card=repr(smi))
    # The track's first 16-chunk call runs op by op (one launch of each
    # carries kernel), its second captures (two: the warm-up and the
    # captured call).
    want = {k: 0 for k in launches}
    want.update(raster_depth_batch=2, render_fused_batch=2,
                track_carries=3, track_envelope=3)
    if launches != want:
        fail(f"stream launch counts {launches} != {want}")
    if tuple(streamed.shape) != (chunks, H, W, 4) or not stream_err <= 1e-5:
        fail(f"the stream's frames differ from the offline sequence by "
             f"{stream_err}")
    for k, n in launches.items():
        path_launches[k] += n
    del streamed, frames

    n_ss = 8
    for _ in range(2):          # warm-up: the 8-chunk track op by op, capture
        sequence(cfg_ss, sig[:n_ss * 1024])
    reset_counts()
    (frames, telem), ss_ms = host_ms(lambda: sequence(cfg_ss,
                                                      sig[:n_ss * 1024]))
    launches = read_counts()
    frames_eq = True
    for f in range(n_ss):
        color = telem["light_color"][f].cpu()
        fb, _ = pipeline.render_frame(
            audio_app.build_scene(light_color=color, device=dev), cam,
            Lighting(light=PointLight(
                color=color, intensity=telem["light_intensity"][f].cpu())),
            cfg_ss, displacement=float(telem["displacement"][f]),
            shadow_target=target, device=dev)
        frames_eq &= torch.equal(fb, frames[f])
    finite = bool(torch.isfinite(frames).all())
    say("sequence", path="per_frame_supersampled", frames=n_ss,
        total_ms=f"{ss_ms:.4f}", per_frame_ms=f"{ss_ms / n_ss:.4f}",
        mpix_s=f"{n_ss * W * H / ss_ms / 1e3:.3f}",
        launches=json.dumps(launches), finite=finite,
        frames_equal_render_frame=frames_eq, card=repr(smi))
    want = {k: 0 for k in launches}
    want.update(raster_depth=n_ss, raster_gbuffer_samples=n_ss,
                sample_bilinear=n_ss)
    if launches != want:
        fail(f"supersampled sequence launch counts {launches} != {want}")
    if not (finite and frames_eq and tuple(frames.shape) == (n_ss, H, W, 4)):
        fail("supersampled sequence frames non-finite, misshapen or unequal "
             "to render_frame")
    for k, n in launches.items():
        path_launches[k] += n
    del frames

    # A small sequence on the card against the CPU run, both branches.
    small = RenderConfig(width=96, height=72, msaa=4, shadow_map_size=128)
    scam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=96 / 72)
    for name, c in (("fused_batch", small),
                    ("per_frame_supersampled",
                     small.replace(shading_per_pixel=False))):
        kw = dict(camera=scam, config=c)
        f_gpu, _ = renderer.render_audio_reactive_sequence(
            sig[3 * 1024:9 * 1024], rate, device=dev, **kw)
        f_cpu, _ = renderer.render_audio_reactive_sequence(
            sig[3 * 1024:9 * 1024], rate, device="cpu", **kw)
        err = float((f_gpu.cpu() - f_cpu).abs().max())
        say("sequence", check="card vs CPU", path=name, size="96x72",
            frames=f_cpu.shape[0], rgba_max_abs_err=err, tol=SS_RGBA_TOL)
        if not err <= SS_RGBA_TOL:
            fail(f"the {name} sequence on the card differs from the CPU run "
                 f"by {err}")

    # 21. BASELINE configs 2, 3 and 5 --------------------------------------
    case_rows = configs_phase(dev, smi, path_launches)

    # 22. the app layer ---------------------------------------------------------
    app_phase(dev, smi, path_launches, sig, rate, serve_med,
              batch_per_frame["flagship"])

    # 23. the brute-force reference backend ----------------------------------
    reference_phase(dev, smi)

    # 24. multi-device rendering on one card ---------------------------------
    parallel_phase(dev, smi, path_launches)

    # 25. the prep graph against the op-by-op prep ----------------------------
    prep_graph_phase(dev, smi)

    # 26. config 5 over a sweep of displacements ------------------------------
    sphere_sweep_phase(dev, smi)

    # 27. the main pass's geometry front end ---------------------------------
    setup_kernel_phase(dev, smi)
    say("time", seconds=f"{time.perf_counter() - start:.1f}", limit=900)

    meta = {"raster_depth": (RASTER_SRC, "raster_pallas.py:865"),
            "render_fused": (RASTER_SRC, "raster_pallas.py:997"),
            "raster_gbuffer": (RASTER_SRC, "raster_pallas.py:865"),
            "raster_gbuffer_samples": (RASTER_SRC, "raster_pallas.py:865"),
            "sample_bilinear": (SAMPLE_SRC, "sample_pallas.py:642"),
            "sample_pyramid": (SAMPLE_SRC, "mip_pallas.py:475"),
            "raster_depth_batch": (RASTER_SRC, "raster_pallas.py:1151"),
            "raster_gbuffer_batch": (RASTER_SRC, "raster_pallas.py:1207"),
            "render_fused_batch": (RASTER_SRC, "raster_pallas.py:1278"),
            "sample_bilinear_batch": (SAMPLE_SRC, "sample_pallas.py:587")}
    meta = {k: (src, f"raster/{tpu}") for k, (src, tpu) in meta.items()}
    meta.update(track_carries=(TRACK_SRC, "audio/analyzer.py:223"),
                track_envelope=(TRACK_SRC, "audio/mapping.py:98"))
    kernels = [kernel_row(name, src, tpu, path_launches[name], *stats[name])
               for name, (src, tpu) in meta.items()]
    print(json.dumps({"kernels": kernels + track_rows + case_rows}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
