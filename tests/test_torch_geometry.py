"""Port parity, triangle setup: clip_near, guard_clip_xy, setup_triangles
and scalar_planes of metalrenderer_tpu_torch against
metalrenderer_tpu, on the same seeded inputs.

Integer and bool outputs (valid, top_left, parent, clip stats) must be
equal. Float outputs are compared with rtol = 1e-5 and an atol of 1e-6
times the largest magnitude of the compared array: both sides are f32, but
XLA:CPU contracts multiply-adds into FMAs (and sums einsums in its own
order) while the port rounds every eager op, and plane coefficients are
differences of much larger products, so the residue scales with the
array's magnitude rather than with each element.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalrenderer_tpu.raster import geometry as jg

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.raster import geometry as pg

torch.set_num_threads(2)
_j_setup = jax.jit(jg.setup_triangles, static_argnums=(1, 2, 3))


def _close(port, ref):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * scale)


def _equal(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _clip_soup(n, seed):
    """Clip-space triangles, some straddling or behind the near plane
    (z < 0), some back-facing."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.3, 3.0, (n, 3))
    xy = rng.uniform(-1.2, 1.2, (n, 3, 2)) * w[..., None]
    z = rng.uniform(-0.6, 1.0, (n, 3)) * w
    return np.concatenate([xy, z[..., None], w[..., None]],
                          axis=-1).astype(np.float32)


W, H = 128, 64


def _screen_tri(screen, z=0.5, w=1.0):
    """Clip-space triangles landing at the given screen coordinates."""
    screen = np.asarray(screen, np.float64)
    ndc_x = screen[..., 0] / (0.5 * W) - 1.0
    ndc_y = 1.0 - screen[..., 1] / (0.5 * H)
    w = np.broadcast_to(np.float64(w), ndc_x.shape)
    z = np.broadcast_to(np.float64(z), ndc_x.shape)
    return np.stack([ndc_x * w, ndc_y * w, z * w, w], -1).astype(np.float32)


@pytest.mark.parametrize("with_attrs", [False, True])
def test_clip_near_matches(with_attrs):
    clip = _clip_soup(200, seed=3)
    attrs = (np.random.default_rng(4).standard_normal((200, 3, 8))
             .astype(np.float32) if with_attrs else None)
    c_j, a_j, p_j = jax.jit(jg.clip_near)(
        jnp.asarray(clip), None if attrs is None else jnp.asarray(attrs))
    c_p, a_p, p_p = pg.clip_near(
        torch.from_numpy(clip), None if attrs is None else torch.from_numpy(attrs))
    _equal(p_p, p_j)
    _close(c_p, c_j)
    if with_attrs:
        _close(a_p, a_j)
    else:
        assert a_p is None


def _guard_inputs():
    rng = np.random.default_rng(7)
    inside = [[[10, 10], [100, 12], [40, 60]], [[5, 50], [120, 40], [60, 2]]]
    far = []
    for _ in range(6):   # one vertex on screen, two thousands of px away
        v_on = rng.uniform([10, 5], [W - 10, H - 5], (1, 2))
        ang = rng.uniform(0, 2 * np.pi, (2,))
        dist = rng.uniform(2e3, 3e4, (2,))
        far.append(np.concatenate(
            [v_on, v_on + np.stack([np.cos(ang) * dist,
                                    np.sin(ang) * dist], -1)]))
    screen = np.concatenate([np.asarray(inside, np.float64),
                             np.stack(far)])
    clip = _screen_tri(screen, w=rng.uniform(0.5, 3.0, (len(screen), 3)))
    attrs = rng.standard_normal((len(screen), 3, 8)).astype(np.float32)
    return clip, attrs


@pytest.mark.parametrize("cap", [8, 3])     # 3 < 6 oversize: overflow kept
def test_guard_clip_xy_matches(cap):
    clip, attrs = _guard_inputs()
    parent = np.arange(len(clip), dtype=np.int32)
    guard_clip = jax.jit(jg.guard_clip_xy, static_argnums=(3, 4, 5, 6))
    c_j, a_j, p_j, s_j = guard_clip(jnp.asarray(clip), jnp.asarray(attrs),
                                    jnp.asarray(parent), W, H, cap, 1000.0)
    c_p, a_p, p_p, s_p = pg.guard_clip_xy(
        torch.from_numpy(clip), torch.from_numpy(attrs),
        torch.from_numpy(parent), W, H, cap=cap, guard_px=1000.0)
    assert int(s_p["xyclip_triangles"]) == int(s_j["xyclip_triangles"]) == \
        min(cap, 6)
    assert int(s_p["xyclip_dropped"]) == int(s_j["xyclip_dropped"]) == \
        max(0, 6 - cap)
    _equal(p_p, p_j)
    _close(c_p, c_j)
    _close(a_p, a_j)
    # The clipped pieces set up into the same valid triangles.
    _equal(pg.setup_triangles(c_p, W, H, cull_backfaces=False).valid,
           _j_setup(c_j, W, H, False).valid)


@pytest.mark.parametrize("cull", [True, False])
def test_setup_triangles_matches(cull):
    clip = _clip_soup(300, seed=5)
    clip[:20, :, 3] = 1e-7                      # w below near_eps: rejected
    clip[20:30, 1] = clip[20:30, 0]             # degenerate (zero area)
    s_j = _j_setup(jnp.asarray(clip), 200, 120, cull)
    s_p = pg.setup_triangles(torch.from_numpy(clip), 200, 120,
                             cull_backfaces=cull)
    _equal(s_p.valid, s_j.valid)
    _equal(s_p.top_left, s_j.top_left)
    assert 0 < int(s_p.valid.sum()) < len(clip)
    for f in ("screen", "z", "inv_w", "edge", "inv_area", "aabb"):
        _close(getattr(s_p, f), getattr(s_j, f))


def test_attribute_and_scalar_planes_match():
    clip = _clip_soup(300, seed=6)
    s_j = _j_setup(jnp.asarray(clip), 200, 120, False)
    s_p = convert.setup_from_jax(s_j)           # same setup on both sides
    _close(pg.scalar_planes(s_p, s_p.z), jg.scalar_planes(s_j, s_j.z))
    _close(pg.scalar_planes(s_p, s_p.inv_w), jg.scalar_planes(s_j, s_j.inv_w))
