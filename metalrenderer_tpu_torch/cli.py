"""Command-line entry points (torch counterpart of
``metalrenderer_tpu.cli``) — replacement for the reference's Cocoa app
shell (main.m / AppDelegate.mm) and the standalone Metal-Tutorial CLI
(Engine/main.mm). The swapchain becomes PNG files; the ImGui telemetry
panel becomes a JSON stream.

Usage:
  python -m metalrenderer_tpu_torch.cli render     [--width W --height H ...]
  python -m metalrenderer_tpu_torch.cli audioapp   --wav in.wav --out-dir frames/
  python -m metalrenderer_tpu_torch.cli flythrough --pose 5,2.5,1.2 --pose 4,3,1.35
  python -m metalrenderer_tpu_torch.cli analyze    --wav in.wav [--dashboard DIR]
  python -m metalrenderer_tpu_torch.cli session    [--events script.jsonl]

Every subcommand renders (or analyzes) on the GPU unless ``--device cpu``
is given; ``--device cuda`` without a GPU raises, nothing falls back to the
CPU. ``main(argv)`` returns what the subcommand produced (frames, stats,
telemetry), for callers that drive the CLI in process.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch


def _add_render_args(p):
    p.add_argument("--width", type=int, default=800)    # mtl_engine.mm:133
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--msaa", type=int, default=4)
    p.add_argument("--shadow-map-size", type=int, default=1024)
    p.add_argument("--backend", default="kernels",
                   choices=["kernels", "reference"],
                   help="kernels (the CUDA kernels, on the CPU their plain "
                        "twins) or reference (the brute-force oracle: no "
                        "binning, no kernel)")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--theta", type=float, default=2.5)
    p.add_argument("--phi", type=float, default=1.2)
    p.add_argument("--cube-pos", type=float, nargs=3, default=[0, 0, -1])
    p.add_argument("--light-pos", type=float, nargs=3, default=[0, 2, 0])
    p.add_argument("--light-color", type=float, nargs=3, default=[1, 1, 1])
    p.add_argument("--displacement", type=float, default=0.0)


def _config_camera(args):
    from .config import RenderConfig
    from .scene.camera import OrbitCamera

    cfg = RenderConfig(width=args.width, height=args.height, msaa=args.msaa,
                       shadow_map_size=args.shadow_map_size)
    cam = OrbitCamera(radius=args.radius, theta=args.theta, phi=args.phi,
                      aspect=args.width / args.height)
    return cfg, cam


def linspace_f32(start, stop, num):
    """``jnp.linspace(start, stop, num)`` in float32 as the JAX package
    computes it: ``start * (1 - s) + stop * s`` at ``s = i / (num - 1)``
    (each operation rounded to f32), the last value ``stop`` itself."""
    start = torch.tensor(start, dtype=torch.float32)
    stop = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(
        div, dtype=torch.float32)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def cmd_render(args):
    from .engine import audio_app
    from .io import png

    cfg, cam = _config_camera(args)
    if args.frames > 1:
        # Orbit turntable sequence through the frame-batch path
        # (render_batch: the whole sequence in a fixed number of kernel
        # launches).
        from .passes.pipeline import render_batch
        from .scene.lights import Lighting

        scene = audio_app.build_scene(tuple(args.cube_pos),
                                      tuple(args.light_pos),
                                      tuple(args.light_color),
                                      device=args.device)
        nf = args.frames
        disps = torch.full((nf,), args.displacement, dtype=torch.float32)
        thetas = torch.tensor(args.theta, dtype=torch.float32) + \
            linspace_f32(0.0, args.orbit, nf)
        fbs, stats = render_batch(
            scene, cam, Lighting.default(), disps, thetas, config=cfg,
            shadow_target=tuple(args.cube_pos), backend=args.backend,
            device=args.device)
        out = pathlib.Path(args.out)
        stem, suffix = out.stem, (out.suffix or ".png")
        host = fbs.cpu().numpy()
        for i in range(nf):
            png.write_png(str(out.with_name(f"{stem}_{i:04d}{suffix}")),
                          host[i])
        print(json.dumps({k: v.tolist() for k, v in stats.items()}))
        print(f"wrote {nf} frames to {stem}_*{suffix}", file=sys.stderr)
        return fbs, stats
    fb, stats = audio_app.render_audio_app(
        cube_position=tuple(args.cube_pos),
        light_position=tuple(args.light_pos),
        light_color=tuple(args.light_color),
        displacement=args.displacement,
        camera=cam, config=cfg, backend=args.backend, device=args.device)
    png.write_png(args.out, fb.cpu().numpy())
    print(json.dumps({k: float(v) for k, v in stats.items()}))
    print(f"wrote {args.out}", file=sys.stderr)
    return fb, stats


def cmd_audioapp(args):
    from .engine.renderer import (render_audio_reactive_sequence,
                                  stream_audio_reactive)
    from .io import png, wav

    samples, rate = wav.read_wav(args.wav)
    mono = samples[0]
    cfg, cam = _config_camera(args)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.stream:
        # Streaming serving mode: frames land incrementally, one batch per
        # --chunk-frames audio buffers (~21 ms each at 48 kHz) — the analog
        # of the reference's live tap cadence (AudioInputLayer.mm:22).
        # Telemetry is one JSON line per chunk with the wall-clock latency
        # of that chunk, its frames on the host.
        import time

        from .audio import analyzer

        if args.max_frames is not None:
            mono = mono[:args.max_frames * analyzer.FFT_SIZE]
        i, chunks, records = 0, [], []
        stream = stream_audio_reactive(
            mono, rate, chunk_frames=args.chunk_frames, camera=cam,
            config=cfg, backend=args.backend,
            cube_position=tuple(args.cube_pos),
            light_position=tuple(args.light_pos), device=args.device)
        while True:
            # The clock wraps the generator pull (the chunk's track, prep
            # and kernels run inside it) and ends with the frames on the
            # host.
            t0 = time.perf_counter()
            try:
                frames, telem = next(stream)
            except StopIteration:
                break
            frames = frames.cpu().numpy()
            latency_ms = (time.perf_counter() - t0) * 1e3
            for f in range(frames.shape[0]):
                png.write_png(out / f"frame_{i + f:05d}.png", frames[f])
            rec = {"chunk_first_frame": i, "frames": int(frames.shape[0]),
                   "fetch_ms": round(latency_ms, 2),
                   "light_intensity": telem["light_intensity"].tolist()}
            print(json.dumps(rec), flush=True)
            chunks.append(frames)
            records.append(rec)
            i += frames.shape[0]
        print(f"streamed {i} frames to {out}", file=sys.stderr)
        return torch.from_numpy(np.concatenate(chunks)), records
    frames, telemetry = render_audio_reactive_sequence(
        mono, rate, camera=cam, config=cfg, backend=args.backend,
        max_frames=args.max_frames,
        cube_position=tuple(args.cube_pos),
        light_position=tuple(args.light_pos), device=args.device)
    host = frames.cpu().numpy()
    for i in range(host.shape[0]):
        png.write_png(out / f"frame_{i:05d}.png", host[i])
    telem = {k: v.tolist() for k, v in telemetry.items()}
    (out / "telemetry.json").write_text(json.dumps(telem, indent=1))
    print(f"wrote {host.shape[0]} frames to {out}", file=sys.stderr)
    return frames, telemetry


def cmd_flythrough(args):
    """Quaternion-slerp camera flythrough of the AudioApp scene: key orbit
    poses -> PoseCamera path -> one frame batch for the whole sequence
    (engine.renderer.render_camera_path)."""
    from .engine import audio_app
    from .engine.renderer import render_camera_path
    from .io import png
    from .scene.camera import OrbitCamera
    from .scene.lights import Lighting

    cfg, _ = _config_camera(args)
    aspect = args.width / args.height
    keys = []
    for spec in args.pose:
        r, t, p_ = (float(x) for x in spec.split(","))
        keys.append(OrbitCamera(radius=r, theta=t, phi=p_, aspect=aspect))
    if len(keys) < 2:
        raise SystemExit("--pose must be given at least twice (r,theta,phi)")
    scene = audio_app.build_scene(cube_position=tuple(args.cube_pos),
                                  light_position=tuple(args.light_pos),
                                  device=args.device)
    frames = render_camera_path(
        scene, Lighting.default(), keys,
        frames_per_segment=args.frames_per_segment, config=cfg,
        displacement=args.displacement,
        shadow_target=tuple(args.cube_pos), backend=args.backend,
        device=args.device)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    host = frames.cpu().numpy()
    for i in range(host.shape[0]):
        png.write_png(out / f"fly_{i:05d}.png", host[i])
    print(f"wrote {host.shape[0]} frames to {out}", file=sys.stderr)
    return frames


def cmd_analyze(args):
    """Telemetry parity with the ImGui overlay (mtl_engine.mm:880-933):
    RMS, rolling average, band energies, pitch + confidence, and the
    MusicalContext per 1024-sample chunk, as JSON lines."""
    from .audio import analyzer, interpreter
    from .io import wav

    samples, rate = wav.read_wav(args.wav)
    _, res = analyzer.analyze_stream(samples[0], float(rate),
                                     device=args.device)
    ctxs = interpreter.interpret(res, float(rate))
    n = res.rms.shape[0]
    cols = {name: getattr(src, name).cpu().tolist() for src, names in (
        (res, ("rms", "rolling_avg", "bass", "mid", "treble", "pitch_hz",
               "pitch_confidence")),
        (ctxs, ("energy", "brightness", "melancholy"))) for name in names}
    for i in range(n):
        print(json.dumps({"chunk": i,
                          **{k: float(v[i]) for k, v in cols.items()}}))
    if args.dashboard:
        # PNG dashboard per chunk (the ImGui spectrum/band panel as
        # images; utils/dashboard.py).
        from .io import png
        from .utils import dashboard
        out = pathlib.Path(args.dashboard)
        out.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = dashboard.render_result_dashboard(
                res, i, context=ctxs, sample_rate=float(rate))
            png.write_png(out / f"dash_{i:05d}.png", img)
        print(f"wrote {n} dashboards to {out}", file=sys.stderr)
    return res, ctxs


def cmd_session(args):
    """Interactive loop analog (MtlEngine::run + GLFW callbacks): JSON
    input events -> camera/scene state -> frames, from stdin or a script
    file. One telemetry JSON line per frame on stdout."""
    from .engine.session import InteractiveSession
    from .io import png

    cfg, cam = _config_camera(args)
    sess = InteractiveSession(
        config=cfg, camera=cam, backend=args.backend,
        cube_pos=tuple(args.cube_pos), light_pos=tuple(args.light_pos),
        light_color=tuple(args.light_color),
        displacement=args.displacement, device=args.device)

    out_dir = pathlib.Path(args.out_dir) if args.out_dir else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    def on_frame(fb, telem):
        if out_dir is not None and telem["frame"] % args.png_every == 0:
            png.write_png(str(out_dir / f"frame_{telem['frame']:05d}.png"),
                          fb.cpu().numpy())

    lines = (pathlib.Path(args.events).read_text().splitlines()
             if args.events else sys.stdin)
    fb, telems = None, []
    for fb, telem in sess.run(lines, on_frame=on_frame):
        print(json.dumps(telem), flush=True)
        telems.append(telem)
    return fb, telems


def build_parser():
    ap = argparse.ArgumentParser(prog="metalrenderer_tpu_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="render device: cuda (the default; raises without "
                         "a GPU) or cpu (the kernels' plain twins)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        p = sub.add_parser(name, **kw)
        p.set_defaults(fn=fn)
        return p

    p = add("render", cmd_render, help="render AudioApp frame(s) to PNG "
            "(--frames N: batched orbit turntable sequence)")
    _add_render_args(p)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--orbit", type=float, default=0.8,
                   help="total orbit angle across --frames (radians)")

    p = add("audioapp", cmd_audioapp,
            help="render an audio-reactive sequence from a WAV")
    _add_render_args(p)
    p.add_argument("--wav", required=True)
    p.add_argument("--out-dir", default="frames")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="render incrementally as audio chunks arrive "
                        "(bounded latency; one frame batch per chunk)")
    p.add_argument("--chunk-frames", type=int, default=16,
                   help="frames (1024-sample buffers) per streamed batch")

    p = add("flythrough", cmd_flythrough,
            help="quaternion-slerp camera flythrough (PNG sequence)")
    _add_render_args(p)
    p.add_argument("--pose", action="append", default=[],
                   help="orbit key pose 'radius,theta,phi' (repeat >= 2x)")
    p.add_argument("--frames-per-segment", type=int, default=24)
    p.add_argument("--out-dir", default="flythrough")

    p = add("session", cmd_session,
            help="interactive loop: JSON input events (stdin or --events "
                 "file) -> camera/scene updates -> frames + telemetry")
    _add_render_args(p)
    p.add_argument("--events", default=None,
                   help="event script file (default: read stdin)")
    p.add_argument("--out-dir", default=None,
                   help="write PNG frames here (default: telemetry only)")
    p.add_argument("--png-every", type=int, default=1,
                   help="write every Nth frame's PNG")

    p = add("analyze", cmd_analyze, help="audio feature telemetry (JSON "
            "lines)")
    p.add_argument("--wav", required=True)
    p.add_argument("--dashboard", default=None, metavar="DIR",
                   help="also render a PNG telemetry dashboard per chunk "
                        "(the ImGui overlay panel as images)")
    return ap


def main(argv=None):
    from .passes.pipeline import resolve_device

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
