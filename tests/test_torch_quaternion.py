"""Port parity, quaternions, cameras and the camera path:
``metalrenderer_tpu_torch.math.quaternion``, ``scene.camera`` (the orbit
camera's interaction and ``PoseCamera``) and
``engine.renderer.render_camera_path`` on the CPU against the JAX package.

Tolerances, with their reasons:
  * BIT-EQUAL: ``conjugate``, ``inverse``, ``multiply``, ``to_matrix3x3``,
    ``to_matrix4x4`` (the JAX functions run op by op here, each product and
    sum rounded on its own, as the port rounds them), and the orbit
    camera's ``process_mouse_movement`` / ``process_mouse_scroll`` state
    (theta added in float64, phi and radius f32, as JAX promotes them);
  * two ulps for ``normalize`` and ``from_matrix3x3`` (2.4e-7, at 1) and
    ``rotate_vector`` (9.6e-7, its vectors up to 4 long): ``jnp.cross``
    and ``jnp.linalg.norm`` are jitted XLA:CPU programs, which contract
    ``a*b - c*d`` and the sum of squares into FMAs (ROADMAP C6), while the
    port rounds every product (as it does on the card); 1e-6 for ``from_axis_angle``, ``from_euler``,
    ``slerp``, ``axis``, ``angle`` and ``length``, which add sin, cos,
    arccos and sqrt, each a library call that torch and XLA:CPU may round
    one ulp apart (PERF.md §6, "Rotations");
  * view matrices within 1e-6 (a PoseCamera's against the JAX one, and an
    orbit camera's ``pose()`` against its own look-at matrix, 1e-6 as the
    JAX test's 1e-5 tightened to what f32 gives);
  * the camera path at 128x64 MSAA1: >= 40 dB against the JAX reference
    path (measured ~100 dB), bit-equal to the port's own ``render_frame``
    at each slerped pose; with the JAX slerped poses carried across
    (``convert.pose_cameras_from_jax``), within the measured 2e-3 of the
    JAX frames and >= 60 dB (the prep's rounding, ROADMAP C9: 1.16e-3
    measured).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metalrenderer_tpu as jmr
from metalrenderer_tpu.engine import audio_app as j_audio_app
from metalrenderer_tpu.engine import renderer as j_renderer
from metalrenderer_tpu.math import quaternion as jq
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app, renderer
from metalrenderer_tpu_torch.math import quaternion as q
from metalrenderer_tpu_torch.math import transforms
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.scene.camera import OrbitCamera, PoseCamera
from metalrenderer_tpu_torch.scene.lights import Lighting

torch.set_num_threads(2)
N = 256
ULP2 = 2.4e-7


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    unit = rng.normal(size=(2, N, 4)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    return {
        "axis": rng.normal(size=(N, 3)).astype(np.float32),
        "angle": rng.uniform(-3, 3, size=N).astype(np.float32),
        "euler": rng.uniform(-3, 3, size=(N, 3)).astype(np.float32),
        "raw": rng.normal(size=(2, N, 4)).astype(np.float32),
        "unit": unit.astype(np.float32),
        "v": rng.normal(size=(N, 3)).astype(np.float32),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _close(a, b, tol):
    a = np.asarray(a, np.float32)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["conjugate", "inverse", "multiply",
                                  "to_matrix3x3", "to_matrix4x4"])
def test_arithmetic_functions_bit_equal_jax(name):
    x = _inputs()
    r0, r1 = x["raw"]
    u0 = x["unit"][0]
    j, t = getattr(jq, name), getattr(q, name)
    if name == "multiply":
        a, b = j(jnp.asarray(r0), jnp.asarray(r1)), t(_t(r0), _t(r1))
    elif name.startswith("to_matrix"):
        a, b = j(jnp.asarray(u0)), t(_t(u0))
    else:
        a, b = j(jnp.asarray(r0)), t(_t(r0))
    assert _bits_equal(a, b), name


@pytest.mark.parametrize("name,tol", [
    ("rotate_vector", 4 * ULP2), ("normalize", ULP2), ("length", 1e-6),
    ("from_matrix3x3", ULP2), ("from_axis_angle", 1e-6),
    ("from_euler", 1e-6), ("axis", 1e-6), ("angle", 1e-6),
    ("slerp", 1e-6)])
def test_rounded_functions_close_to_jax(name, tol):
    x = _inputs(1)
    u0, u1 = x["unit"]
    r0 = x["raw"][0]
    if name == "rotate_vector":
        a = jq.rotate_vector(jnp.asarray(u0), jnp.asarray(x["v"]))
        b = q.rotate_vector(_t(u0), _t(x["v"]))
    elif name in ("normalize", "length"):
        a, b = getattr(jq, name)(jnp.asarray(r0)), getattr(q, name)(_t(r0))
    elif name == "from_matrix3x3":
        m = np.asarray(jq.to_matrix3x3(jnp.asarray(u0)))
        a, b = jq.from_matrix3x3(jnp.asarray(m)), q.from_matrix3x3(_t(m))
    elif name == "from_axis_angle":
        a = jq.from_axis_angle(x["axis"], x["angle"])
        b = q.from_axis_angle(x["axis"], x["angle"])
    elif name == "from_euler":
        a, b = jq.from_euler(x["euler"]), q.from_euler(x["euler"])
    elif name in ("axis", "angle"):
        a, b = getattr(jq, name)(jnp.asarray(u0)), getattr(q, name)(_t(u0))
    else:
        t = np.float32(0.37)
        a = jq.slerp(jnp.asarray(u0), jnp.asarray(u1), t)
        b = q.slerp(_t(u0), _t(u1), t)
    _close(a, b, tol)


def test_from_matrix_takes_first_maximum_on_ties():
    # The identity ties no score; a 180-degree turn about x ties the
    # y and z scores at 0 and picks x; the zero matrix ties all four
    # scores at 1 and takes the first (w), as jnp.argmax does.
    for m in (np.eye(3), np.diag([1.0, -1.0, -1.0]), np.zeros((3, 3))):
        m = m.astype(np.float32)
        assert _bits_equal(jq.from_matrix3x3(jnp.asarray(m)),
                           q.from_matrix3x3(_t(m)))


# --- the JAX package's own quaternion cases (tests/test_quaternion.py) ----

def _axis_angles(n, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ax = rng.normal(size=3)
        yield (torch.tensor(ax / np.linalg.norm(ax), dtype=torch.float32),
               float(rng.uniform(-3, 3)))


def test_axis_angle_matches_rotation_matrix():
    for ax, ang in _axis_angles(10):
        m_q = q.to_matrix4x4(q.from_axis_angle(ax, ang))
        torch.testing.assert_close(m_q, transforms.rotation(ang, ax),
                                   rtol=0, atol=1e-5)


def test_multiply_composes_like_matrices():
    (a_ax, a_ang), (b_ax, b_ang) = _axis_angles(2)
    qa, qb = q.from_axis_angle(a_ax, a_ang), q.from_axis_angle(b_ax, b_ang)
    torch.testing.assert_close(
        q.to_matrix3x3(q.multiply(qa, qb)),
        transforms.matmul(q.to_matrix3x3(qa), q.to_matrix3x3(qb)),
        rtol=0, atol=1e-5)


def test_rotate_vector_matches_matrix_and_roundtrips():
    for ax, ang in _axis_angles(20):
        qq = q.from_axis_angle(ax, ang)
        v = torch.tensor([0.3, -1.2, 0.7])
        torch.testing.assert_close(
            q.rotate_vector(qq, v),
            transforms.matmul(q.to_matrix3x3(qq), v[:, None])[:, 0],
            rtol=0, atol=1e-5)
        q2 = q.from_matrix3x3(q.to_matrix3x3(qq))
        # q and -q are the same rotation.
        assert min(float((q2 - qq).abs().max()),
                   float((q2 + qq).abs().max())) < 1e-5
        ident = q.multiply(qq, q.inverse(qq))
        torch.testing.assert_close(ident, q.identity(), rtol=0, atol=1e-5)


def test_slerp_endpoints_and_midpoint():
    q0 = q.identity()
    q1 = q.from_axis_angle([0.0, 1.0, 0.0], np.pi / 2)
    torch.testing.assert_close(q.slerp(q0, q1, 0.0), q0, rtol=0, atol=1e-6)
    torch.testing.assert_close(q.slerp(q0, q1, 1.0), q1, rtol=0, atol=1e-6)
    mid = q.slerp(q0, q1, 0.5)
    torch.testing.assert_close(
        mid, q.from_axis_angle([0.0, 1.0, 0.0], np.pi / 4), rtol=0,
        atol=1e-6)
    assert abs(float(q.angle(mid)) - np.pi / 4) < 1e-5
    # Nearly equal keys take the lerp branch; opposite signs the short way.
    near = q.normalize(q0 + torch.tensor([1e-7, 0.0, 0.0, 0.0]))
    assert bool(torch.isfinite(q.slerp(q0, near, 0.5)).all())
    torch.testing.assert_close(q.slerp(q0, -q1, 0.5), mid, rtol=0,
                               atol=1e-6)


# --- cameras ----------------------------------------------------------------

def _state(cam):
    return tuple(float(np.asarray(getattr(cam, f)))
                 for f in ("radius", "theta", "phi", "aspect"))


def test_mouse_movement_and_scroll_state_bit_equal_jax():
    """A run of updates (phi clamped at both poles, the radius at 0.5):
    the float64 theta, f32 phi and radius equal JAX's after every one."""
    rng = np.random.default_rng(11)
    j = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=1.5)
    t = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=1.5)
    moves = [(float(dx), float(dy)) for dx, dy in rng.normal(0, 40, (24, 2))]
    moves += [(0.0, 2000.0), (3.0, -5000.0), (-7.0, 13.0)]
    for i, (dx, dy) in enumerate(moves):
        j, t = j.process_mouse_movement(dx, dy), t.process_mouse_movement(dx,
                                                                          dy)
        if i % 3 == 0:
            s = float(rng.normal(0, 3)) if i < 20 else 100.0
            j, t = j.process_mouse_scroll(s), t.process_mouse_scroll(s)
        assert _state(j) == _state(t), i
    assert isinstance(t.theta, float)
    assert t.phi.dtype == torch.float32 and t.radius.dtype == torch.float32
    assert float(t.radius) == 0.5
    assert 0.001 <= float(t.phi) <= np.pi - 0.0009


def test_mouse_movement_semantics():
    cam = OrbitCamera()
    # Camera.cpp:33-38: theta += dx*0.005; phi -= dy*0.0025.
    cam2 = cam.process_mouse_movement(10.0, 4.0)
    assert float(cam2.theta) == pytest.approx(3.14 + 0.05, rel=1e-12)
    assert float(cam2.phi) == pytest.approx(1.57 - 0.01, rel=1e-6)
    assert float(OrbitCamera(radius=1.0).process_mouse_scroll(1.0).radius) \
        == pytest.approx(0.8, rel=1e-6)
    assert float(OrbitCamera(radius=1.0).process_mouse_scroll(100.0)
                 .radius) == 0.5
    assert OrbitCamera().with_aspect(2.0).aspect == 2.0


def test_orbit_pose_matches_look_at():
    for theta, phi in ((2.5, 1.2), (0.3, 0.4), (-2.0, 2.9)):
        cam = OrbitCamera(radius=5.0, theta=theta, phi=phi, aspect=4 / 3)
        pc = cam.pose()
        torch.testing.assert_close(pc.view_matrix(), cam.view_matrix(),
                                   rtol=0, atol=1e-6)
        assert torch.equal(pc.projection_matrix(), cam.projection_matrix())


def test_pose_camera_against_jax():
    keys = [(5.0, 2.5, 1.2, 4 / 3), (3.5, 3.2, 1.4, 4 / 3)]
    jp = [JCamera(radius=r, theta=t, phi=p, aspect=a).pose()
          for r, t, p, a in keys]
    tp = [OrbitCamera(radius=r, theta=t, phi=p, aspect=a).pose()
          for r, t, p, a in keys]
    for a, b in zip(jp, tp):
        _close(a.orientation, b.orientation, ULP2)
        _close(a.position, b.position, 0.0)
        _close(a.view_matrix(), b.view_matrix(), 1e-6)
        _close(a.projection_matrix(), b.projection_matrix(), 0.0)
    for t in (0.0, 0.3, 1.0):
        a, b = jp[0].slerp(jp[1], t), tp[0].slerp(tp[1], t)
        _close(a.view_matrix(), b.view_matrix(), 1e-6)
        _close(a.projection_matrix(), b.projection_matrix(), 0.0)
    # A PoseCamera carried across renders the JAX pose's exact matrix
    # from the same quaternion.
    c = convert.pose_camera_from_jax(jp[0])
    assert isinstance(c, PoseCamera)
    _close(jp[0].view_matrix(), c.view_matrix(), 1e-6)


# --- the camera path -------------------------------------------------------

W, H = 128, 64
KEYS = [(5.0, 2.5, 1.2), (4.0, 3.0, 1.35)]
CFG = RenderConfig(width=W, height=H, msaa=1, shadow_map_size=64)


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def jax_path():
    """The JAX reference path's frames and its slerped poses."""
    keys = [JCamera(radius=r, theta=t, phi=p, aspect=W / H)
            for r, t, p in KEYS]
    frames = j_renderer.render_camera_path(
        j_audio_app.build_scene(), jmr.Lighting.default(), keys,
        frames_per_segment=2,
        config=jmr.RenderConfig(width=W, height=H, msaa=1,
                                shadow_map_size=64),
        backend="reference")
    poses = [k.pose() for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *poses)
    idx = jnp.arange(3)
    seg = jnp.minimum(idx // 2, 0)
    t = (idx - seg * 2).astype(jnp.float32) / 2

    def frame_cam(s, tt):
        a = jax.tree.map(lambda x: x[s], stacked)
        b = jax.tree.map(lambda x: x[s + 1], stacked)
        return a.slerp(b, tt)
    return np.asarray(frames), jax.vmap(frame_cam)(seg, t)


def test_camera_path_matches_jax_and_render_frame(jax_path, monkeypatch):
    j_frames, j_cams = jax_path
    called = []
    fn = renderer.render_frame_batch_fused
    monkeypatch.setattr(renderer, "render_frame_batch_fused",
                        lambda *a, **k: called.append(1) or fn(*a, **k))
    scene = audio_app.build_scene(device="cpu")
    keys = [OrbitCamera(radius=r, theta=t, phi=p, aspect=W / H)
            for r, t, p in KEYS]
    frames = renderer.render_camera_path(scene, Lighting.default(), keys,
                                         frames_per_segment=2, config=CFG,
                                         device="cpu")
    assert called == [1]            # one fused batch for the whole path
    assert frames.shape == (3, H, W, 4)
    cams = renderer.camera_path(keys, 2)
    assert all(isinstance(c, PoseCamera) for c in cams)
    # Each frame's uniforms carry its own eye position.
    eyes = {tuple(c.position.tolist()) for c in cams}
    assert len(eyes) == 3
    for i, cam in enumerate(cams):
        assert _psnr(frames[i].numpy(), j_frames[i]) >= 40.0
        fb, _ = pipeline.render_frame(scene, cam, Lighting.default(), CFG,
                                      device="cpu")
        assert torch.equal(fb, frames[i]), i
    for i, cam in enumerate(convert.pose_cameras_from_jax(j_cams)):
        fb, _ = pipeline.render_frame(scene, cam, Lighting.default(), CFG,
                                      device="cpu")
        assert float(np.abs(fb.numpy() - j_frames[i]).max()) <= 2e-3
        assert _psnr(fb.numpy(), j_frames[i]) >= 60.0


def test_camera_path_segments_and_frame_loop():
    """Three keys, 3 frames a segment: 7 frames, keys at 0, 3 and 6 (t in
    f32 as JAX computes it); a supersampled config takes the frame loop,
    and each frame is render_frame's."""
    keys = [OrbitCamera(radius=5.0, theta=th, phi=1.2, aspect=1.0)
            for th in (2.5, 2.8, 3.1)]
    cams = renderer.camera_path(keys, 3)
    assert len(cams) == 7
    for i, k in ((0, 0), (3, 1), (6, 2)):
        torch.testing.assert_close(cams[i].view_matrix(),
                                   keys[k].view_matrix(), rtol=0, atol=1e-6)
    cfg = RenderConfig(width=32, height=32, msaa=1, shadow_map_size=64,
                       shading_per_pixel=False)
    scene = audio_app.build_scene(device="cpu")
    frames = renderer.render_camera_path(scene, Lighting.default(), keys[:2],
                                         frames_per_segment=1, config=cfg,
                                         device="cpu")
    assert frames.shape == (2, 32, 32, 4)
    fb, _ = pipeline.render_frame(scene, keys[1].pose(), Lighting.default(),
                                  cfg, device="cpu")
    assert torch.equal(fb, frames[1])


def test_camera_path_px_batch_for_textured_scene(monkeypatch):
    """The grass-textured cube takes the px batch (K4 + K5 + K8 + K9) with
    PoseCameras; each frame equals render_frame at its pose."""
    called = []
    fn = renderer.render_frame_batch_px
    monkeypatch.setattr(renderer, "render_frame_batch_px",
                        lambda *a, **k: called.append(1) or fn(*a, **k))
    cfg = RenderConfig(width=32, height=32, msaa=1, shadow_map_size=64)
    scene = audio_app.build_scene(textures=(audio_app.grass_texture(),),
                                  cube_texture_id=0, device="cpu")
    keys = [OrbitCamera(radius=5.0, theta=th, phi=1.2, aspect=1.0)
            for th in (2.5, 3.0)]
    frames = renderer.render_camera_path(scene, Lighting.default(), keys,
                                         frames_per_segment=2, config=cfg,
                                         device="cpu")
    assert called == [1] and frames.shape == (3, 32, 32, 4)
    for i, cam in enumerate(renderer.camera_path(keys, 2)):
        fb, _ = pipeline.render_frame(scene, cam, Lighting.default(), cfg,
                                      device="cpu")
        assert torch.equal(fb, frames[i]), i


def test_camera_path_needs_two_poses():
    with pytest.raises(ValueError, match="two key poses"):
        renderer.render_camera_path(audio_app.build_scene(device="cpu"),
                                    Lighting.default(), [OrbitCamera()],
                                    config=CFG, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_camera_path_on_card_matches_cpu(cuda_device):
    """The flythrough's fused batch (K4 + K6 with PoseCameras) on the card
    against the CPU run at 64x48: rgba within 1e-5 (K6's twin bar)."""
    keys = [OrbitCamera(radius=r, theta=t, phi=p, aspect=64 / 48)
            for r, t, p in KEYS]
    cfg = RenderConfig(width=64, height=48, msaa=4, shadow_map_size=64)
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = renderer.render_camera_path(
            audio_app.build_scene(device=dev), Lighting.default(), keys,
            frames_per_segment=2, config=cfg, device=dev).cpu()
    assert float((out["cpu"] - out[str(cuda_device)]).abs().max()) <= 1e-5
