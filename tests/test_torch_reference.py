"""Port parity, the brute-force reference backend: ``geometry.coverage``,
``raster/reference_cpu.py``, the array-of-structs shading API of
``raster/shade.py`` and ``render_frame(backend="reference")``, against the
JAX package's on the CPU.

Bars (ROADMAP C6, C9):
  * visibility on JAX's own triangle setup: depth bit-equal to a numpy
    evaluation in the same operation order with no FMA; against the JAX
    brute force (whose scan XLA:CPU contracts into FMAs) depth within 2e-7
    anchored and 4e-6 independent on the same plane coefficients, winners
    equal on the flagship, and on a z-fight soup different only on counted
    z-fight samples (the best two depths within 2 ulp). The port's own
    depth planes (``scalar_planes``, a sum of separately rounded products
    where JAX takes a dot) move the anchored depth by up to 4.8e-7 on the
    flagship: held within 1e-6 of JAX with the winners still equal;
  * the G-buffer interpolated from the same winners: integers equal, floats
    within 1e-5 (relative, for world positions beyond 1); the shading API
    on JAX's G-buffer within 1e-5;
  * whole frames against the JAX reference: >= 60 dB and within the
    measured bound (the prep's rounding, C9), the goldens >= 40 dB;
  * the port's kernels (their plain twins here) against its reference:
    >= 40 dB, and the per-sample G-buffer twin's (K3s) winners equal to the
    brute force's except on counted z-fight samples.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metalrenderer_tpu as mr
from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.passes import pipeline as j_pipe
from metalrenderer_tpu.raster import geometry as j_geom
from metalrenderer_tpu.raster import reference_cpu as j_ref
from metalrenderer_tpu.raster import shade as j_shade
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.scene import bake as j_bake, project as j_project

from benchmarks import configs as j_configs

from metalrenderer_tpu_torch import cli, convert, render, render_batch
from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app, configs, renderer
from metalrenderer_tpu_torch.engine.session import InteractiveSession
from metalrenderer_tpu_torch.io import png
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import (geometry, raster_cuda,
                                            reference_cpu, shade)
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting

torch.set_num_threads(2)
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
CENTER = ((0.5, 0.5),)
ANCHORS = [None, (128, 8)]
ANCHOR_IDS = ["independent", "anchored"]
W, H = 160, 120
JCFG = JConfig(width=W, height=H, msaa=4, shadow_map_size=256)
JCAM = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


# --------------------------------------------------------------------------
# The JAX package's rasterizer rules (tests/test_raster_reference.py) on the
# port, in both plane formulations
# --------------------------------------------------------------------------

def _ndc_tri(v0, v1, v2, z=0.5):
    """A clip-space triangle from NDC xy at constant depth."""
    tri = np.zeros((1, 3, 4), np.float32)
    for i, v in enumerate((v0, v1, v2)):
        tri[0, i] = [v[0], v[1], z, 1.0]
    return torch.from_numpy(tri)


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
def test_fullscreen_ccw_triangle_covers_center(anchor):
    s = geometry.setup_triangles(_ndc_tri((-3, -3), (3, -3), (0, 3)), 8, 8)
    assert bool(s.valid[0])
    depth, win = reference_cpu.rasterize_brute_force(s, 8, 8, CENTER, anchor)
    assert int(win[0, 4, 4]) == 0 and win.dtype == torch.int32
    assert abs(float(depth[0, 4, 4]) - 0.5) <= 1e-6


def test_cw_triangle_is_backface_culled():
    clip = _ndc_tri((-3, -3), (0, 3), (3, -3))
    assert not bool(geometry.setup_triangles(clip, 8, 8).valid[0])
    assert bool(geometry.setup_triangles(clip, 8, 8,
                                         cull_backfaces=False).valid[0])


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
def test_half_screen_coverage_fraction(anchor):
    s = geometry.setup_triangles(_ndc_tri((-1, -1), (1, -1), (-1, 1)), 64, 64)
    _, win = reference_cpu.rasterize_brute_force(s, 64, 64, CENTER, anchor)
    assert abs(float((win[0] >= 0).float().mean()) - 0.5) < 0.02


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
def test_shared_edge_watertight(anchor):
    """Two triangles sharing a diagonal cover every pixel exactly once."""
    quad = torch.tensor([
        [[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [1, 1, 0.5, 1]],
        [[-1, -1, 0.5, 1], [1, 1, 0.5, 1], [-1, 1, 0.5, 1]],
    ], dtype=torch.float32)
    s = geometry.setup_triangles(quad, 32, 32)
    hits = torch.zeros((32, 32), dtype=torch.int32)
    for t in range(2):
        only = s.replace(valid=s.valid & (torch.arange(2) == t))
        _, win = reference_cpu.rasterize_brute_force(only, 32, 32, CENTER,
                                                     anchor)
        hits += (win[0] >= 0).to(torch.int32)
    assert int(hits.min()) == 1 and int(hits.max()) == 1


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
@pytest.mark.parametrize("order,expect,z", [
    ((0.5, 0.5), 1, 0.5),        # equal depths: the LATER submission wins
    ((0.2, 0.8), 0, 0.2),        # the nearer wins whatever the order
    ((0.8, 0.2), 1, 0.2)])
def test_depth_test_less_equal(order, expect, z, anchor):
    clip = torch.cat([_ndc_tri((-3, -3), (3, -3), (0, 3), zz) for zz in order])
    s = geometry.setup_triangles(clip, 8, 8)
    depth, win = reference_cpu.rasterize_brute_force(s, 8, 8, CENTER, anchor)
    assert int(win[0, 4, 4]) == expect
    assert abs(float(depth[0, 4, 4]) - z) <= 1e-6


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
def test_triangle_order_commutes_for_distinct_depths(anchor):
    rng = np.random.default_rng(0)
    tris = []
    for k in range(8):
        center = rng.uniform(-0.7, 0.7, 2)
        pts = center + rng.uniform(0.1, 0.8, (3, 2)) * \
            np.array([[1, 0], [0, 1], [-1, -0.5]])
        d1, d2 = pts[1] - pts[0], pts[2] - pts[0]
        if d1[0] * d2[1] - d1[1] * d2[0] < 0:
            pts = pts[::-1]
        z = 0.1 + 0.1 * k
        tris.append([[p[0], p[1], z, 1] for p in pts])
    tris = torch.tensor(np.asarray(tris, np.float32))
    perm = torch.from_numpy(rng.permutation(8))
    d1, _ = reference_cpu.rasterize_brute_force(
        geometry.setup_triangles(tris, 48, 48), 48, 48, CENTER, anchor)
    d2, _ = reference_cpu.rasterize_brute_force(
        geometry.setup_triangles(tris[perm], 48, 48), 48, 48, CENTER, anchor)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
def test_perspective_correct_interpolation(anchor):
    """u along an edge from w=1 to w=4: at the screen midpoint the
    perspective-correct value is (1/4) / (1 + 1/4) = 0.2, not 0.5."""
    clip = torch.tensor([[[-0.5, -0.5, 0.2, 1.0], [2.0, -2.0, 2.0, 4.0],
                          [-0.5, 2.0, 0.2, 1.0]]])
    n = 65
    s = geometry.setup_triangles(clip, n, n)
    depth, win = reference_cpu.rasterize_brute_force(s, n, n, CENTER, anchor)
    uvs = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    vattrs = torch.cat([torch.zeros(3, 3), uvs, torch.zeros(3, 3)], -1)[None]
    g = reference_cpu.interpolate_gbuffer(
        s, win, n, n, CENTER, vattrs, torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, 3), -torch.ones(1, dtype=torch.int32), depth)
    assert abs(float(g.uv[0, 48, 32, 0]) - 0.2) < 0.02
    assert int(g.normal_map_id.max()) == -1


def test_coverage_matches_jax():
    """The top-left rule on samples exactly on edges (exact arithmetic, so
    JAX's FMAs change nothing): equal to the JAX function's."""
    clip = np.array([[[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [1, 1, 0.5, 1]],
                     [[-1, -1, 0.5, 1], [1, 1, 0.5, 1], [-1, 1, 0.5, 1]],
                     [[1, 1, 0.5, 1], [-1, 1, 0.5, 1], [0, -1, 0.5, 1]]],
                    np.float32)
    js = j_geom.setup_triangles(jnp.asarray(clip), 16, 16,
                                cull_backfaces=False)
    s = convert.setup_from_jax(js)
    g = np.arange(0.0, 16.5, 0.5, dtype=np.float32)
    px, py = [a.reshape(-1) for a in np.meshgrid(g, g)]
    want = np.asarray(j_geom.coverage(js.edge, js.top_left, px, py))
    got = geometry.coverage(s.edge, s.top_left, torch.from_numpy(px),
                            torch.from_numpy(py))
    assert got.shape == want.shape == (3, px.size)
    assert np.array_equal(got.numpy(), want) and want.any() and not want.all()


# --------------------------------------------------------------------------
# Visibility on JAX's own triangle setup
# --------------------------------------------------------------------------

def _main_pass(geom, cam, cfg):
    """JAX's main-pass setup and pass geometry, as one jitted program."""
    return jax.jit(lambda g, v, p: j_pipe.prepare_main_pass(g, v, p, cfg))(
        geom, cam.view_matrix(), cam.projection_matrix())


def _flagship_setup():
    return _main_pass(j_bake(j_app.build_scene(), 0.02), JCAM, JCFG)


def _soup_setup(seed=11, n_pairs=60, n_single=80, min_area2=200.0):
    """Seeded clip-space soup at w in [1, 2], both windings kept: single
    triangles and pairs of different triangles on one plane (z-fights).
    Every triangle spans at least ``min_area2`` / 2 px^2: on a sliver the
    direct barycentrics' 1/area amplifies XLA's FMA rounding past the bars
    (6.9e-5 of depth on a 0.25 px^2 triangle), though the port stays
    bit-equal to numpy there too."""
    rng = np.random.default_rng(seed)
    scale = np.array([W / 2, H / 2])
    tris = []
    for k in range(n_pairs + n_single):
        c = rng.uniform(-0.9, 0.9, 2)
        plane = rng.uniform(-0.2, 0.2, 3) + np.array([0.5, 0.0, 0.0])
        for _ in range(2 if k < n_pairs else 1):
            while True:
                xy = c + rng.uniform(-0.45, 0.45, (3, 2))
                d1, d2 = (xy[1] - xy[0]) * scale, (xy[2] - xy[0]) * scale
                if abs(d1[0] * d2[1] - d1[1] * d2[0]) >= min_area2:
                    break
            z = plane[0] + plane[1] * xy[:, 0] + plane[2] * xy[:, 1]
            tris.append(np.concatenate([xy, z[:, None], np.ones((3, 1))],
                                       axis=1) * rng.uniform(1.0, 2.0))
    clip = jnp.asarray(np.asarray(tris, np.float32))
    return j_geom.setup_triangles(clip, W, H, cull_backfaces=False)


def _numpy_brute_force(s, anchor, samples):
    """The scan of the JAX oracle in numpy float32 (no FMA), on the port's
    setup and depth planes."""
    offs = np.asarray(samples, np.float32)
    pyi, pxi = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ox_ = offs[:, 0][:, None, None]
    oy_ = offs[:, 1][:, None, None]
    edge, tl = s.edge.numpy(), s.top_left.numpy()
    if anchor is not None:
        tw, th = anchor
        xr = (pxi % tw).astype(np.float32)[None] + ox_
        yr = (pyi % th).astype(np.float32)[None] + oy_
        ox = ((pxi // tw) * tw).astype(np.float32)[None]
        oy = ((pyi // th) * th).astype(np.float32)[None]
        planes = geometry.scalar_planes(s, s.z).numpy()

        def ev(a, b, c):
            return (a * xr + b * yr) + ((c + a * ox) + b * oy)
    else:
        sx = pxi.astype(np.float32)[None] + ox_
        sy = pyi.astype(np.float32)[None] + oy_
        z, inv_area = s.z.numpy(), s.inv_area.numpy()

        def ev(a, b, c):
            return (a * sx + b * sy) + c
    shape = (offs.shape[0], H, W)
    zbuf = np.ones(shape, np.float32)
    win = np.full(shape, -1, np.int32)
    for t in np.nonzero(s.valid.numpy())[0]:
        e = [ev(*edge[t, k]) for k in range(3)]
        cov = np.ones(shape, bool)
        for k in range(3):
            cov &= (e[k] >= 0.0) if tl[t, k] else (e[k] > 0.0)
        if anchor is not None:
            zp = ev(*planes[t])
        else:
            zp = ((e[1] * inv_area[t]) * z[t, 0]
                  + (e[2] * inv_area[t]) * z[t, 1]) \
                + (e[0] * inv_area[t]) * z[t, 2]
        m = cov & (zp >= 0.0) & (zp <= 1.0) & (zp <= zbuf)
        zbuf = np.where(m, zp, zbuf)
        win = np.where(m, t, win)
    return zbuf, win


def _numpy_interpolate(s, winner, w, h, samples, vattrs):
    """``interpolate_gbuffer``'s attributes in numpy float32 (no FMA), in
    the same operation order: f32[S, H, W, 8]."""
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    edge, inv_area, inv_w = (s.edge.numpy(), s.inv_area.numpy(),
                             s.inv_w.numpy())
    out = []
    for k, (ox, oy) in enumerate(np.asarray(samples, np.float32)):
        sx = px.astype(np.float32) + ox
        sy = py.astype(np.float32) + oy
        t = np.maximum(winner[k], 0)
        e = (edge[t][..., 0] * sx[..., None] + edge[t][..., 1] * sy[..., None]
             + edge[t][..., 2])
        wgt = np.stack([e[..., 1], e[..., 2], e[..., 0]], -1) * \
            inv_area[t][..., None]
        wgt = wgt * inv_w[t]
        den = (wgt[..., 0:1] + wgt[..., 1:2]) + wgt[..., 2:3]
        wgt = wgt / np.where(den == 0.0, np.float32(1.0), den)
        g = vattrs[t]
        out.append((g[..., 0, :] * wgt[..., 0, None]
                    + g[..., 1, :] * wgt[..., 1, None])
                   + g[..., 2, :] * wgt[..., 2, None])
    return np.stack(out)


def _zfights(setup, anchor, samples, win, win_other, tol):
    """Where the winners ``win`` and ``win_other`` (i32[S, H, W]) differ:
    how many samples, and whether at every one both triangles cover the
    sample at depths within ``tol`` of each other (a z-fight)."""
    idx = torch.nonzero((win != win_other).reshape(-1)).squeeze(1)
    z0, hit0 = reference_cpu.depth_at_samples(
        setup, W, H, samples, idx, win.reshape(-1)[idx], anchor)
    z1, hit1 = reference_cpu.depth_at_samples(
        setup, W, H, samples, idx, win_other.reshape(-1)[idx], anchor)
    ok = hit0 & hit1 & ((z0 - z1).abs() <= tol)
    return int(idx.numel()), bool(ok.all())


@pytest.mark.parametrize("anchor", ANCHORS, ids=ANCHOR_IDS)
@pytest.mark.parametrize("case", ["flagship", "soup"])
def test_brute_force_matches_numpy_and_jax(case, anchor, monkeypatch):
    js = _flagship_setup()[0] if case == "flagship" else _soup_setup()
    samples = tuple(JCFG.sample_positions)
    s = convert.setup_from_jax(js)
    depth, win = reference_cpu.rasterize_brute_force(s, W, H, samples, anchor)
    assert depth.shape == win.shape == (4, H, W)
    n_cov = int((win >= 0).sum())
    assert 0.2 * win.numel() < n_cov < win.numel()
    # Bit-equal to numpy with no FMA on the port's setup and planes.
    zbuf, nwin = _numpy_brute_force(s, anchor, samples)
    assert np.array_equal(depth.numpy().view(np.int32), zbuf.view(np.int32))
    assert np.array_equal(win.numpy(), nwin)

    dj, wj = (convert.tensor(a) for a in j_ref.rasterize_brute_force(
        js, W, H, samples, anchor=anchor))
    tol = 2e-7 if anchor else 4e-6
    if anchor:
        if case == "flagship":
            # The port's own depth planes: their rounding, not the brute
            # force's, sets the difference (measured 4.8e-7).
            assert float((depth - dj).abs().max()) <= 1e-6
            assert torch.equal(win, wj)
        # The brute force itself, on JAX's planes.
        jplanes = convert.tensor(j_geom.scalar_planes(js, js.z))
        monkeypatch.setattr(reference_cpu, "scalar_planes",
                            lambda setup, z: jplanes)
        depth, win = reference_cpu.rasterize_brute_force(s, W, H, samples,
                                                         anchor)
    both = (win >= 0) & (wj >= 0)
    assert float((depth - dj)[both].abs().max()) <= tol
    if case == "flagship":
        assert torch.equal(win, wj)
    # Elsewhere the winners differ only where both candidates cover the
    # sample within the depth bar of each other (measured on the soup: 87
    # samples anchored, 876 independent, of ~71,000 covered).
    n_diff, all_zfights = _zfights(s, anchor, samples, win, wj, tol)
    assert all_zfights, f"{n_diff} samples differ, not all z-fights"
    assert n_diff <= 0.02 * n_cov


@pytest.fixture(scope="module")
def config4_jax():
    """BASELINE config 4 (a textured, normal-mapped cube, a directional
    light, a 128^2 shadow map) at 64x48 through the JAX reference: its
    main-pass setup and pass geometry, the anchored brute force's depth
    and winners, the G-buffer, the shadow context, scene, camera and
    lighting."""
    scene, cam, lighting, cfg = j_configs.config4_shadow_normal_map(64, 48)
    cfg = cfg.replace(shadow_map_size=128)
    geom = j_bake(scene)
    setup, pg = _main_pass(geom, cam, cfg)
    samples = tuple(cfg.sample_positions)
    depth, winner = j_ref.rasterize_brute_force(
        setup, 64, 48, samples, anchor=(cfg.tile_w, cfg.tile_h))
    gbuf = j_ref.interpolate_gbuffer(setup, winner, 64, 48, samples,
                                     pg.vattrs, pg.mat_kind, pg.mat_color,
                                     pg.tex_id, depth,
                                     normal_map_id=pg.normal_map_id)
    light = lighting.light
    anchor = j_lights.light_anchor_position(light, (0.0, 0.0, 0.0),
                                            mr.ShadowConfig())
    lv = j_lights.light_view_matrix(anchor, jnp.zeros(3, jnp.float32))
    lp = j_lights.light_projection_matrix(mr.ShadowConfig())
    clip_l = j_project(geom.world, lv, lp)
    clip_l2, _, parent = j_geom.clip_near(clip_l.reshape(-1, 3, 4))
    setup_l = j_geom.setup_triangles(clip_l2, 128, 128, cull_backfaces=False)
    setup_l = setup_l.replace(valid=setup_l.valid & geom.cast_shadow[parent])
    ctx = j_shade.ShadowContext(
        depth_map=j_ref.rasterize_depth_brute_force(setup_l, 128, 128),
        light_view=lv, light_proj=lp)
    return dict(setup=setup, pg=pg, samples=samples, depth=depth,
                winner=winner, gbuf=gbuf, ctx=ctx, scene=scene, cam=cam,
                lighting=lighting)


@pytest.mark.parametrize("case", ["flagship", "config4"])
def test_interpolate_gbuffer_matches_jax(case, request):
    if case == "flagship":
        js, jpg = _flagship_setup()
        samples, w, h = tuple(JCFG.sample_positions), W, H
        dj, wj = j_ref.rasterize_brute_force(js, w, h, samples,
                                             anchor=(128, 8))
        gj = j_ref.interpolate_gbuffer(js, wj, w, h, samples, jpg.vattrs,
                                       jpg.mat_kind, jpg.mat_color,
                                       jpg.tex_id, dj,
                                       normal_map_id=jpg.normal_map_id)
    else:
        c4 = request.getfixturevalue("config4_jax")
        js, jpg, samples, dj, wj, gj = (c4[k] for k in (
            "setup", "pg", "samples", "depth", "winner", "gbuf"))
        w, h = 64, 48
    pg = convert.pass_geometry_from_jax(jpg)
    g = reference_cpu.interpolate_gbuffer(
        convert.setup_from_jax(js), convert.tensor(wj), w, h, samples,
        pg.vattrs, pg.mat_kind, pg.mat_color, pg.tex_id, convert.tensor(dj),
        normal_map_id=pg.normal_map_id)
    ref = convert.gbuffer_from_jax(gj)
    for f in ("mat_kind", "tex_id", "normal_map_id", "covered", "depth",
              "mat_color"):
        assert torch.equal(getattr(g, f), getattr(ref, f)), f
    # Bit-equal to numpy with no FMA.
    attrs = torch.cat([g.world, g.uv, g.normal], dim=-1).numpy()
    want = _numpy_interpolate(convert.setup_from_jax(js), np.asarray(wj), w,
                              h, samples, pg.vattrs.numpy())
    assert np.array_equal(attrs.view(np.int32), want.view(np.int32))
    # Within 1e-5 of JAX (relative beyond 1: world positions reach |x| ~ 13
    # on the floor), but for samples where XLA's FMA in e = a*x + b*y + c
    # loses digits to a guard-band triangle's |c| ~ 1e9 (measured: 2 of
    # 36,864 config-4 values, 3.8e-4 relative).
    ref_attrs = torch.cat([ref.world, ref.uv, ref.normal], dim=-1).numpy()
    err = np.abs(attrs - ref_attrs) / np.maximum(1.0, np.abs(ref_attrs))
    assert (err > 1e-5).mean() <= 1e-4 and err.max() <= 1e-3
    if case == "config4":
        assert int((g.normal_map_id >= 0).sum()) > 0


# --------------------------------------------------------------------------
# The array-of-structs shading API on JAX's G-buffer of config 4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["shade", "blinn_phong", "shadow_factor",
                                "resolve_base_color", "apply_normal_maps",
                                "channels_from_gbuffer"])
def test_aos_shading_matches_jax(fn, config4_jax):
    gj, ctx_j, scene_j, cam, lighting = (config4_jax[k] for k in (
        "gbuf", "ctx", "scene", "cam", "lighting"))
    g = convert.gbuffer_from_jax(gj)
    ctx = convert.shadow_context_from_jax(ctx_j)
    tex_j = scene_j.textures
    tex = convert.scene_from_jax(scene_j).textures
    # Host copies of the JAX values (no views of JAX buffers).
    pos = np.array(cam.position, np.float32)
    lpos = np.array([0.0, 4.0, 0.0], np.float32)
    color = np.array(lighting.light.color, np.float32)
    if fn == "shade":
        out = shade.shade(g, pos, lpos, color, 0.1, 32.0,
                          (0.1, 0.1, 0.1, 1.0), shadow_ctx=ctx, textures=tex,
                          normal_map_ids=g.normal_map_id)
        want = j_shade.shade(gj, pos, lpos, color, 0.1, 32.0,
                             (0.1, 0.1, 0.1, 1.0), shadow_ctx=ctx_j,
                             textures=tex_j, normal_map_ids=gj.normal_map_id)
    elif fn == "blinn_phong":
        out = shade.blinn_phong(g.world, g.normal, g.mat_color, pos, lpos,
                                color, 0.1, 32.0)
        want = j_shade.blinn_phong(gj.world, gj.normal, gj.mat_color, pos,
                                   lpos, color, 0.1, 32.0)
    elif fn == "shadow_factor":
        out = shade.shadow_factor(g.world, ctx)
        want = j_shade.shadow_factor(gj.world, ctx_j)
        assert 0 < int((out == 0.5).sum()) < out.numel()
    elif fn == "resolve_base_color":
        out = shade.resolve_base_color(g.mat_color, g.tex_id, g.uv, tex)
        want = j_shade.resolve_base_color(gj.mat_color, gj.tex_id, gj.uv,
                                          tex_j)
    elif fn == "apply_normal_maps":
        out = shade.apply_normal_maps(g, tex, g.normal_map_id).normal
        want = j_shade.apply_normal_maps(gj, tex_j, gj.normal_map_id).normal
        assert not torch.equal(out, g.normal)
    else:
        ch = shade.channels_from_gbuffer(g)
        want_ch = j_shade.channels_from_gbuffer(gj)
        assert set(ch) == set(want_ch)
        out = torch.stack([ch[k].to(torch.float32) for k in sorted(ch)])
        want = np.stack([np.asarray(want_ch[k], np.float32)
                         for k in sorted(want_ch)])
    want = np.asarray(want)
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)


def test_untiled_sampler_matches_jax():
    """``tiled_sampler=False`` reads a map with the plain gather sampler at
    every fragment, per-frame maps frame by frame (JAX ``_sample2d``)."""
    rng = np.random.default_rng(3)
    tex = rng.uniform(0.0, 1.0, (2, 16, 16)).astype(np.float32)
    u, v = (rng.uniform(-0.5, 1.5, (2, 6, 7)).astype(np.float32)
            for _ in range(2))
    for t, uu, vv in ((tex, u, v), (tex[0], u[0], v[0])):
        want = np.asarray(j_shade._sample2d(jnp.asarray(t), jnp.asarray(uu),
                                            jnp.asarray(vv), "repeat", False))
        got = shade._sample2d_untiled(torch.from_numpy(t),
                                      torch.from_numpy(uu),
                                      torch.from_numpy(vv), "repeat", 1.0,
                                      torch.zeros(uu.shape, dtype=bool))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Whole frames
# --------------------------------------------------------------------------

def _frames(case):
    """(port frame and stats, JAX frame and stats) on the reference
    backend."""
    if case == "config4":
        w, h = 128, 96
        scene, cam, lighting, cfg = configs.config4_shadow_normal_map(
            w, h, device="cpu")
        js, jcam, jl, jcfg = j_configs.config4_shadow_normal_map(w, h)
        port = pipeline.render_frame(
            scene, cam, lighting, cfg.replace(shadow_map_size=128),
            backend="reference", device="cpu")
        return port, mr.render(js, jcam, jl,
                               jcfg.replace(shadow_map_size=128),
                               backend="reference")
    kw, jkw = {}, {}
    if case == "grass":
        kw = dict(textures=(audio_app.grass_texture(),), cube_texture_id=0)
        jkw = dict(textures=(j_app.grass_texture(),), cube_texture_id=0)
    port = audio_app.render_audio_app(
        displacement=0.02, camera=convert.camera_from_jax(JCAM),
        config=RenderConfig(width=W, height=H, msaa=4, shadow_map_size=256),
        backend="reference", device="cpu", **kw)
    return port, j_app.render_audio_app(displacement=0.02, camera=JCAM,
                                        config=JCFG, backend="reference",
                                        **jkw)


# The largest channel difference from the JAX reference, measured (the
# prep's rounding, ROADMAP C9): flagship 4.3e-4, config 4 1.3e-4, grass
# cube 4.3e-4.
@pytest.mark.parametrize("case,bound", [("flagship", 5e-4), ("config4", 2e-4),
                                        ("grass", 5e-4)])
def test_reference_frame_matches_jax(case, bound):
    (fb, st), (fb_j, st_j) = _frames(case)
    before = dict(raster_cuda.LAUNCHES)
    fb_j = np.asarray(fb_j)
    assert fb.shape == fb_j.shape and torch.isfinite(fb).all()
    assert _psnr(fb.numpy(), fb_j) >= 60.0
    assert float(np.abs(fb.numpy() - fb_j).max()) <= bound
    assert set(st) == set(st_j)
    for k in st_j:
        ref = np.asarray(st_j[k])
        if np.issubdtype(ref.dtype, np.integer):
            assert int(st[k]) == int(ref), k
        else:
            assert abs(float(st[k]) - float(ref)) <= 1e-6 * max(
                1.0, abs(float(ref))), k
    assert raster_cuda.LAUNCHES == before


@pytest.mark.parametrize("golden", ["audio_app", "grass_cube"])
def test_reference_frame_matches_golden(golden):
    kw = {} if golden == "audio_app" else dict(
        textures=(audio_app.grass_texture(),), cube_texture_id=0)
    fb, _ = audio_app.render_audio_app(
        camera=OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H),
        config=RenderConfig(width=W, height=H, msaa=4,
                            shadow_map_size=128 if kw else 256),
        backend="reference", device="cpu", **kw)
    want = png.read_png(GOLDENS / f"{golden}_{W}x{H}.png")
    assert _psnr(fb.numpy()[..., :3],
                 want[..., :3].astype(np.float32) / 255.0) >= 40.0


@pytest.mark.parametrize("case", ["flagship", "config4", "supersampled"])
def test_kernels_match_reference(case):
    """The kernels' frame (plain twins) against the reference frame of the
    same inputs, and the K3s twin's winners on the kernels' bins against
    the brute force's on the same setup."""
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
    if case == "config4":
        scene, cam, lighting, cfg = configs.config4_shadow_normal_map(
            W, H, device="cpu")
        cfg = cfg.replace(shadow_map_size=256)
    else:
        scene, lighting = audio_app.build_scene(device="cpu"), \
            Lighting.default()
        cfg = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=256,
                           shading_per_pixel=case == "flagship")
    args = (scene, cam, lighting, cfg, ShadowConfig(), 0.02,
            (0.0, 0.0, -1.0))
    fb_k, st_k = pipeline.render_frame(*args, device="cpu")
    fb_r, st_r = pipeline.render_frame(*args, backend="reference",
                                       device="cpu")
    assert _psnr(fb_k.numpy(), fb_r.numpy()) >= 40.0
    assert abs(float(st_k["covered_fraction"])
               - float(st_r["covered_fraction"])) <= 1e-6
    samples = tuple(cfg.sample_positions)
    bins = pipeline.prepare_frame(*args, device="cpu").main_bins
    setup = pipeline.prepare_frame(*args, backend="reference",
                                   device="cpu").main_setup
    _, _, win_k = raster_cuda.raster_gbuffer_samples(bins, W, H, samples)
    anchor = (cfg.tile_w, cfg.tile_h)
    _, win_r = reference_cpu.rasterize_brute_force(setup, W, H, samples,
                                                   anchor)
    # The same arithmetic on the same setup: a difference would be a fault
    # of the tile lists, unless both candidates tie within 2 ulp.
    n_diff, all_zfights = _zfights(setup, anchor, samples, win_k, win_r,
                                   2.0 ** -23)
    assert all_zfights, f"{n_diff} samples differ, not all z-fights"
    assert int((win_r >= 0).sum()) > 0.3 * win_r.numel()


# --------------------------------------------------------------------------
# The entry points take backend="reference"
# --------------------------------------------------------------------------

def test_entry_points_accept_reference(tmp_path):
    w = h = 32
    cfg = RenderConfig(width=w, height=h, msaa=4, shadow_map_size=64)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2)
    scene = audio_app.build_scene(device="cpu")
    kw = dict(backend="reference", device="cpu")
    target = (0.0, 0.0, -1.0)
    one, st = pipeline.render_frame(scene, cam, Lighting.default(), cfg,
                                    shadow_target=target, **kw)
    assert torch.equal(render(scene, cam, Lighting.default(), cfg,
                              shadow_target=target, **kw)[0], one)
    rgba, bst = render_batch(scene, cam, Lighting.default(), [0.0, 0.0],
                             [2.5, 2.5], config=cfg, shadow_target=target,
                             **kw)
    assert torch.equal(rgba[0], one) and torch.equal(rgba[1], one)
    assert torch.equal(bst["covered_fraction"][0], st["covered_fraction"])
    prep = pipeline.prepare_frame(scene, cam, Lighting.default(), cfg,
                                  shadow_target=target, **kw)
    assert isinstance(prep, pipeline.ReferencePrep)
    with pytest.raises(ValueError, match="backend='kernels'"):
        pipeline.render_frame_batch_fused(
            scene, cam, Lighting.default(), cfg, ShadowConfig(), [0.0],
            [2.5], **kw)
    app, _ = audio_app.render_audio_app(config=cfg, camera=cam, **kw)
    sess = InteractiveSession(config=cfg, camera=cam, **kw)
    assert torch.equal(sess.render_frame()[0], app)
    pose = cam.pose()
    path = renderer.render_camera_path(scene, Lighting.default(),
                                       [pose, pose], 2, config=cfg, **kw)
    assert path.shape == (3, h, w, 4) and torch.equal(path[0], path[2])
    t = np.arange(2 * 1024) / 48000.0
    frames, _ = renderer.render_audio_reactive_sequence(
        (0.01 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32), 48000.0,
        camera=cam, config=cfg, **kw)
    assert frames.shape == (2, h, w, 4) and torch.isfinite(frames).all()
    out = tmp_path / "f.png"
    fb_cli, _ = cli.main(["--device", "cpu", "render", "--backend",
                          "reference", "--width", "32", "--height", "32",
                          "--shadow-map-size", "64", "--out", str(out)])
    assert out.exists() and torch.isfinite(fb_cli).all()
    for bad in ("pallas", "brute"):
        with pytest.raises(ValueError, match="unknown rasterizer backend"):
            pipeline.render_frame(scene, cam, Lighting.default(), cfg,
                                  backend=bad, device="cpu")
