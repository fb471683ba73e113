"""Port parity, the command line: ``python -m metalrenderer_tpu_torch.cli``
(render, audioapp, flythrough, analyze, session) with ``--device cpu`` at
small sizes against the JAX package's CLI on the same arguments (with
``--backend reference``, as tests/test_engine_sequence.py runs it): the
files written, the JSON keys, and the values within the bars of the
modules underneath.

Tolerances, with their reasons:
  * frames (PNG, 8 bits) >= 40 dB against the JAX CLI's (the BASELINE.md
    bar; the kernels' twins against the oracle, ROADMAP C9);
  * render stats: the same keys, integer counts equal, covered fraction
    within 1e-2 (edge pixels of the prep's rounding at 64x48);
  * the audio track and analyze lines: 1e-5 relative with the absolute
    floors of tests/test_torch_audio.py (``close``, ``track_floor``);
  * session telemetry: equal camera and scene values (host-side state,
    held bit-equal in tests/test_torch_session.py);
  * the turntable's thetas BIT-EQUAL to ``theta + jnp.linspace(0, orbit,
    N)`` (``cli.linspace_f32``).
"""
import json
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu import cli as j_cli

from test_torch_audio import close, seeded_signal, track_floor

from metalrenderer_tpu_torch import cli
from metalrenderer_tpu_torch.io import png, wav

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--width", "64", "--height", "48", "--msaa", "1",
         "--shadow-map-size", "64"]


def _psnr(a, b):
    a = a.astype(np.float32) / 255.0
    b = b.astype(np.float32) / 255.0
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def _both(tmp_path, capsys, argv, out_flag=None):
    """Run the JAX CLI (reference backend) and the port's CLI (--device cpu)
    with ``argv``; ``out_flag`` names the output argument, given a path of
    each run's own. Returns ((jax_dir, jax_stdout), (port_dir, port_stdout,
    port_result))."""
    runs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        extra = [out_flag, str(d / ("f.png" if out_flag == "--out"
                                    else "out"))] if out_flag else []
        if name == "jax":
            backend = [] if argv[0] == "analyze" else ["--backend",
                                                       "reference"]
            j_cli.main([*argv, *extra, *backend])
            runs.append((d, capsys.readouterr().out))
        else:
            res = cli.main(["--device", "cpu", argv[0], *argv[1:], *extra])
            runs.append((d, capsys.readouterr().out, res))
    return runs


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _tree(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _stats_match(a, b):
    assert set(a) == set(b)
    for k in a:
        if k in ("covered_fraction",):
            np.testing.assert_allclose(b[k], a[k], atol=1e-2)
        elif k.endswith(("triangles", "dropped")):
            assert a[k] == b[k], k


def test_help_lists_subcommands():
    proc = subprocess.run([sys.executable, "-m", "metalrenderer_tpu_torch.cli",
                           "--help"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for cmd in ("render", "audioapp", "flythrough", "analyze", "session"):
        assert cmd in proc.stdout


def test_backend_reference_and_missing_gpu_raise(tmp_path):
    """``--backend reference`` renders the brute-force oracle's frame: the
    PNG of ``render_audio_app(backend="reference")``, within a rounding of
    the kernels' frame. Without a GPU the default device raises and writes
    nothing."""
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    ref = tmp_path / "ref.png"
    fb, _ = cli.main(["--device", "cpu", "render", "--backend", "reference",
                      *SMALL, "--out", str(ref)])
    cfg = RenderConfig(width=64, height=48, msaa=1, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=64 / 48)
    want, _ = audio_app.render_audio_app(camera=cam, config=cfg,
                                         backend="reference", device="cpu")
    assert torch.equal(fb, want)
    assert png.read_png(ref).shape[:2] == (48, 64)
    kern, _ = audio_app.render_audio_app(camera=cam, config=cfg,
                                         device="cpu")
    assert float((kern - fb).abs().max()) <= 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["render", *SMALL, "--out", str(tmp_path / "f.png")])
    assert not (tmp_path / "f.png").exists()
    assert cli.build_parser().parse_args(["render"]).device == "cuda"


@pytest.mark.parametrize("frames", [1, 2])
def test_render_matches_jax_cli(tmp_path, capsys, frames):
    (jd, jout), (td, tout, (fb, stats)) = _both(
        tmp_path, capsys, ["render", *SMALL, "--frames", str(frames)],
        out_flag="--out")
    names = ["f.png"] if frames == 1 else [f"f_{i:04d}.png"
                                           for i in range(frames)]
    assert _tree(jd) == _tree(td) == names
    for n in names:
        assert _psnr(png.read_png(td / n), png.read_png(jd / n)) >= 40.0
    (jst,), (tst,) = _json_lines(jout), _json_lines(tout)
    _stats_match(jst, tst)
    assert tuple(fb.shape) == ((48, 64, 4) if frames == 1
                               else (frames, 48, 64, 4))
    # The PNG is the returned framebuffer, quantized.
    assert np.array_equal(png.read_png(td / names[-1]),
                          png.to_u8(fb.reshape(-1, 48, 64, 4)[-1].numpy()
                                    )[..., :3])


def test_turntable_thetas_bit_equal_jnp_linspace():
    for theta, orbit, n in ((2.5, 0.8, 8), (2.5, 0.8, 2), (-1.3, 6.1, 17),
                            (0.0, 1.0, 1)):
        want = np.asarray(theta + jnp.linspace(0.0, orbit, n))
        got = (torch.tensor(theta, dtype=torch.float32)
               + cli.linspace_f32(0.0, orbit, n)).numpy()
        assert want.dtype == got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_flythrough_matches_jax_cli(tmp_path, capsys):
    (jd, _), (td, _, frames) = _both(
        tmp_path, capsys, ["flythrough", *SMALL, "--pose", "5,2.5,1.2",
                           "--pose", "4,3.0,1.35", "--frames-per-segment",
                           "2"], out_flag="--out-dir")
    names = [f"out/fly_{i:05d}.png" for i in range(3)]
    assert _tree(jd) == _tree(td) == names
    for n in names:
        assert _psnr(png.read_png(td / n), png.read_png(jd / n)) >= 40.0
    assert tuple(frames.shape) == (3, 48, 64, 4)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "flythrough", "--pose", "5,2.5,1.2"])


@pytest.fixture
def wav_path(tmp_path):
    """A 3-chunk seeded WAV (a tone, then noise), 16-bit PCM."""
    sig = seeded_signal()
    p = tmp_path / "in.wav"
    wav.write_wav(p, np.concatenate([sig[6 * 1024:8 * 1024],
                                     sig[12 * 1024:13 * 1024]]), 48000)
    return p


@pytest.mark.parametrize("stream", [False, True])
def test_audioapp_matches_jax_cli(tmp_path, capsys, wav_path, stream):
    argv = ["audioapp", *SMALL, "--wav", str(wav_path)]
    if stream:
        argv += ["--stream", "--chunk-frames", "2"]
    (jd, jout), (td, tout, (frames, telem)) = _both(
        tmp_path, capsys, argv, out_flag="--out-dir")
    names = [f"out/frame_{i:05d}.png" for i in range(3)]
    if not stream:
        names.append("out/telemetry.json")
    assert _tree(jd) == _tree(td) == sorted(names)
    for n in names[:3]:
        assert _psnr(png.read_png(td / n), png.read_png(jd / n)) >= 40.0
    assert tuple(frames.shape) == (3, 48, 64, 4)
    if stream:
        jl, tl = _json_lines(jout), _json_lines(tout)
        assert [sorted(r) for r in jl] == [sorted(r) for r in tl]
        assert [(r["chunk_first_frame"], r["frames"]) for r in tl] == \
            [(0, 2), (2, 1)] == [(r["chunk_first_frame"], r["frames"])
                                 for r in jl]
        assert telem == tl and all(r["fetch_ms"] > 0 for r in tl)
        close(np.concatenate([r["light_intensity"] for r in tl]),
              np.concatenate([r["light_intensity"] for r in jl]))
    else:
        jt = json.loads((jd / "out/telemetry.json").read_text())
        tt = json.loads((td / "out/telemetry.json").read_text())
        assert set(jt) == set(tt) == set(telem)
        for k in tt:
            close(np.asarray(tt[k]), np.asarray(jt[k]), msg=k,
                  floor=track_floor({"pitch_hz": "dominant_pitch"}.get(k, k)))


def test_analyze_dashboard_matches_jax_cli(tmp_path, capsys, wav_path):
    (jd, jout), (td, tout, (res, ctx)) = _both(
        tmp_path, capsys, ["analyze", "--wav", str(wav_path)],
        out_flag="--dashboard")
    names = [f"out/dash_{i:05d}.png" for i in range(3)]
    assert _tree(jd) == _tree(td) == names
    jl, tl = _json_lines(jout), _json_lines(tout)
    assert len(jl) == len(tl) == 3 == res.rms.shape[0]
    for a, b in zip(jl, tl):
        assert list(a) == list(b)
        for k in a:
            close(np.float32(b[k]), np.float32(a[k]), msg=k,
                  floor=track_floor(k))
    for n in names:
        a, b = png.read_png(jd / n), png.read_png(td / n)
        assert np.mean(np.any(a != b, axis=-1)) <= 0.005


def test_session_matches_jax_cli(tmp_path, capsys):
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in [
        {"type": "cursor", "x": 10.0, "y": 10.0},
        {"type": "cursor", "x": 30.0, "y": 4.0, "shift": True},
        {"type": "scroll", "dy": 3.0},
        {"type": "set", "light_color": [0.2, 0.9, 0.3]},
        {"type": "resize", "width": 48, "height": 32},
        {"type": "frame", "n": 2}]) + "\n")
    (jd, jout), (td, tout, (fb, telems)) = _both(
        tmp_path, capsys, ["session", *SMALL, "--events", str(events),
                           "--png-every", "2"], out_flag="--out-dir")
    names = [f"out/frame_{i:05d}.png" for i in (2, 4, 6)]
    assert _tree(jd) == _tree(td) == names
    for n in names:
        assert _psnr(png.read_png(td / n), png.read_png(jd / n)) >= 40.0
    jl, tl = _json_lines(jout), _json_lines(tout)
    assert len(jl) == len(tl) == 7 and tl == telems
    for a, b in zip(jl, tl):
        assert set(a) == set(b)
        for k in a:
            if k != "stats":
                assert a[k] == b[k], k
        _stats_match(a["stats"], b["stats"])
    assert tuple(fb.shape) == (32, 48, 4)
