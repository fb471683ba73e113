"""Port parity, the interactive session: ``metalrenderer_tpu_torch.engine.
session.InteractiveSession`` on the CPU — the event semantics of the
reference's GLFW callbacks (mtl_engine.mm:164-202) and ImGui sliders
(mtl_engine.mm:883-885), the JAX package's own session cases
(tests/test_session.py), and a scripted run through both packages'
sessions.

Tolerances, with their reasons:
  * camera state (radius, theta, phi, aspect) BIT-EQUAL to the JAX
    session's after every event: the updates run on the host with JAX's
    dtypes (theta float64, phi and radius f32);
  * telemetry: the same keys (stats included) and the same scene values;
  * frames >= 40 dB against the JAX ``backend="reference"`` session (the
    BASELINE.md bar; the kernels' twins against the oracle, ROADMAP C9);
  * a session frame BIT-EQUAL to ``render_audio_app`` with the same state.
"""
import json

import numpy as np
import pytest
import torch

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine.session import InteractiveSession as JSession
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera

from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.engine.session import InteractiveSession
from metalrenderer_tpu_torch.scene.camera import OrbitCamera

torch.set_num_threads(2)
CFG = RenderConfig(width=96, height=72, msaa=1, shadow_map_size=64)


def _session(config=CFG, device="cpu", **kw):
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2,
                      aspect=config.width / config.height)
    return InteractiveSession(config=config, camera=cam, device=device, **kw)


def test_cursor_rotation_is_shift_gated():
    s = _session()
    s.handle_event({"type": "cursor", "x": 100.0, "y": 100.0})
    t0 = float(s.camera.theta)
    # Unshifted move: anchor tracks, camera unchanged (mtl_engine.mm:183).
    s.handle_event({"type": "cursor", "x": 150.0, "y": 90.0})
    assert float(s.camera.theta) == t0
    # Shifted move rotates by delta * sensitivity (Camera.cpp:33-38).
    s.handle_event({"type": "cursor", "x": 190.0, "y": 90.0, "shift": True})
    assert float(s.camera.theta) == pytest.approx(t0 + 40.0 * 0.005)
    # The reference REVERSES the vertical delta (yoffset = lastY - ypos,
    # mtl_engine.mm:177): the cursor moving down the screen raises phi.
    p0 = float(s.camera.phi)
    s.handle_event({"type": "cursor", "x": 190.0, "y": 140.0, "shift": True})
    assert float(s.camera.phi) == pytest.approx(p0 + 50.0 * 0.005 * 0.5)


def test_scroll_dolly_clamps_min_radius():
    s = _session()
    s.handle_event({"type": "scroll", "dy": 1000.0})
    assert float(s.camera.radius) == pytest.approx(0.5)


def test_set_and_frame_events():
    s = _session()
    assert s.handle_event({"type": "set", "light_color": [0.1, 0.2, 0.3],
                           "displacement": 0.25}) == 1
    assert s.light_color == (0.1, 0.2, 0.3)
    assert s.displacement == 0.25
    assert s.handle_event({"type": "frame", "n": 3}) == 3
    with pytest.raises(ValueError):
        s.handle_event({"type": "warp"})


def test_resize_updates_config_and_aspect():
    s = _session()
    s.handle_event({"type": "resize", "width": 128, "height": 64})
    assert (s.config.width, s.config.height) == (128, 64)
    assert float(s.camera.aspect) == pytest.approx(2.0)


def test_session_frame_matches_direct_render():
    s = _session(light_color=(0.3, 0.9, 0.4), displacement=0.1)
    s.handle_event({"type": "drag", "dx": 40.0, "dy": -20.0})
    fb_sess, _ = s.render_frame()
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2,
                      aspect=96 / 72).process_mouse_movement(40.0, -20.0)
    fb_direct, _ = audio_app.render_audio_app(
        light_color=(0.3, 0.9, 0.4), displacement=0.1, camera=cam,
        config=CFG, device="cpu")
    assert torch.equal(fb_sess, fb_direct)


def test_run_loop_emits_telemetry_per_frame():
    s = _session()
    lines = ["# comment", "",
             json.dumps({"type": "scroll", "dy": 1.0}),
             json.dumps({"type": "frame", "n": 2})]
    seen = []
    telems = [t for _, t in s.run(lines,
                                  on_frame=lambda fb, t: seen.append(
                                      (tuple(fb.shape), t["frame"])))]
    assert [t["frame"] for t in telems] == [1, 2, 3]
    assert seen == [((72, 96, 4), 1), ((72, 96, 4), 2), ((72, 96, 4), 3)]
    assert telems[0]["camera"]["radius"] == pytest.approx(4.8)
    assert "covered_fraction" in telems[0]["stats"]
    json.dumps(telems)                     # plain JSON values throughout


def test_cursor_event_with_missing_fields_is_safe():
    s = _session()
    s.handle_event({"type": "cursor", "shift": True})
    t0 = float(s.camera.theta)
    s.handle_event({"type": "cursor", "x": 10.0, "y": 0.0, "shift": True})
    assert float(s.camera.theta) == pytest.approx(t0 + 10.0 * 0.005)


def test_session_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        InteractiveSession(config=CFG)


# --- a scripted run through both sessions ----------------------------------

SCRIPT = [
    {"type": "cursor", "x": 100.0, "y": 100.0},
    {"type": "cursor", "x": 130.0, "y": 95.0},
    {"type": "cursor", "x": 171.0, "y": 83.0, "shift": True},
    {"type": "cursor", "x": 160.0, "y": 140.5, "shift": True},
    {"type": "drag", "dx": -35.0, "dy": 12.5},
    {"type": "scroll", "dy": 2.5},
    {"type": "set", "light_color": [0.9, 0.4, 0.2], "displacement": 0.05},
    {"type": "set", "cube_pos": [0.3, 0.0, -1.2],
     "light_pos": [0.5, 2.2, 0.1]},
    {"type": "drag", "dx": 60.0, "dy": 800.0},
    {"type": "resize", "width": 48, "height": 32},
    {"type": "cursor", "x": 90.0, "y": 70.0, "shift": True},
    {"type": "scroll", "dy": 100.0},
    {"type": "scroll", "dy": -20.0},
    {"type": "resize", "width": 64, "height": 48},
    {"type": "frame", "n": 2},
]


@pytest.fixture(scope="module")
def scripted_runs():
    cfg = RenderConfig(width=64, height=48, msaa=1, shadow_map_size=64)
    jcfg = JConfig(width=64, height=48, msaa=1, shadow_map_size=64)
    lines = [json.dumps(e) for e in SCRIPT]
    j = JSession(config=jcfg, backend="reference",
                 camera=JCamera(radius=5.0, theta=2.5, phi=1.2,
                                aspect=64 / 48))
    t = _session(cfg)
    states = []
    for e in SCRIPT:
        j.handle_event(e)
        t.handle_event(e)
        states.append([tuple(float(np.asarray(getattr(s.camera, f)))
                             for f in ("radius", "theta", "phi", "aspect"))
                       for s in (j, t)])
    j_out = [(np.asarray(fb), tel) for fb, tel in JSession(
        config=jcfg, backend="reference",
        camera=JCamera(radius=5.0, theta=2.5, phi=1.2,
                       aspect=64 / 48)).run(lines)]
    t_out = [(fb.numpy(), tel) for fb, tel in _session(cfg).run(lines)]
    return states, j_out, t_out


def test_scripted_camera_state_bit_equal_jax(scripted_runs):
    states, _, _ = scripted_runs
    for i, (js, ts) in enumerate(states):
        assert js == ts, (i, SCRIPT[i])
    # The script reaches the minimum radius and clamps phi at the pole.
    assert min(s[1][0] for s in states) == 0.5
    assert min(s[1][2] for s in states) == pytest.approx(0.001, abs=1e-7)


def test_scripted_telemetry_and_frames_match_jax(scripted_runs):
    _, j_out, t_out = scripted_runs
    assert len(t_out) == len(j_out) == len(SCRIPT) + 1
    for (jf, jt), (tf, tt) in zip(j_out, t_out):
        assert set(tt) == set(jt)
        assert set(tt["stats"]) == set(jt["stats"])
        for k in ("frame", "camera", "cube_pos", "light_pos", "light_color",
                  "displacement", "width", "height"):
            assert tt[k] == jt[k], k
        assert tf.shape == jf.shape == (tt["height"], tt["width"], 4)
        mse = np.mean((np.clip(tf, 0, 1) - np.clip(jf, 0, 1)) ** 2)
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) >= 40.0, tt["frame"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_session_frame_on_card_matches_cpu(cuda_device):
    """One session frame (K1 + K2) on the card against the CPU session at
    64x48 MSAA4 after the same events: camera state equal, rgba within
    1e-5 (K2's twin bar)."""
    cfg = RenderConfig(width=64, height=48, msaa=4, shadow_map_size=64)
    out = []
    for dev in ("cpu", cuda_device):
        s = _session(cfg, device=dev)
        for e in SCRIPT[:9]:
            s.handle_event(e)
        fb, _ = s.render_frame()
        out.append((fb.cpu(), s.telemetry({})["camera"]))
    assert out[0][1] == out[1][1]
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-5
