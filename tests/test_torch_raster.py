"""Port parity, the four raster kernels: the plain twins of
``raster_depth`` (K1), ``render_fused`` (K2), ``raster_gbuffer`` (K3) and
``raster_gbuffer_samples`` (K3s) against the JAX Pallas kernels in interpret mode, fed the SAME converted JAX
triangle setup and field tables, so only the kernels are compared; and, on
a CUDA device, each CUDA kernel against its twin.

Tolerances, with their reasons:
  * winners and covered fractions: equal (integer / exact counts);
  * K1 depth: bit-equal to a numpy evaluation of the anchored planes with
    every multiply and add rounded on its own — the rounding of the Pallas
    kernel on the TPU, and of the CUDA kernel (``-fmad=false``). Against
    the interpret-mode Pallas kernel depth agrees to 1e-6 only: XLA:CPU
    contracts ``a*xr + b*yr`` into an FMA (its LLVM backend always allows
    FP-op fusion), which the TPU and the port do not;
  * K2 rgba: 1e-5 absolute — shading divides, takes square roots and a
    ``pow`` that XLA:CPU and torch evaluate with different approximations
    and FMA contraction; pixels that differ because the Pallas kernel falls
    back to "lit" outside its shadow-map window (ROADMAP C1) are counted;
  * K3 gout: covered counts and per-sample winners equal; attribute rows
    bit-equal to a numpy evaluation that rounds every step; within 1e-6
    relative to their magnitude of the interpret-mode kernel's (its
    ``a*sx + b*sy + c`` is FMA-contracted, ROADMAP C6) but for a count of
    values fixed per case at the count measured: on long guard-band
    triangles the Pallas kernel's planes of value/w carry the f32 rounding
    of their coefficients, up to 3.7e-5, and the port, which weights each
    vertex's value/w by its edge values, does not (C13); and every value
    within ``REF_TOL`` (1e-4) relative of the JAX package's brute-force
    reference (``reference_cpu.interpolate_gbuffer``), whose own rounding
    on those triangles reaches 4.2e-5 against the Pallas kernel;
  * K3s gout (every sample's winner's rows at that sample, on 8x128 and
    16x128 tiles, MSAA4 and MSAA1): winners equal, depth as K1's, the 15
    attribute rows as K3's (bit-equal to the no-FMA numpy evaluation,
    against the interpret-mode kernel as K3's), row 15 bit-equal to the
    twin's own depth and 1e-6 of the kernel's;
  * K1's, K2's and K3's twins with every tile's candidates permuted:
    bit-equal to themselves unpermuted (the order-free visibility that lets
    the kernels stage and chunk candidates in any order);
  * K1 and K4 without the winner plane (``with_winner=False``, the shadow
    pass's form): depth bit-equal to the winner-carrying form, and None in
    the winner's place.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.passes import pipeline as j_pipe
from metalrenderer_tpu.raster import binning as jb
from metalrenderer_tpu.raster import raster_pallas, reference_cpu
from metalrenderer_tpu.raster import sampling as j_sampling
from metalrenderer_tpu.raster.geometry import clip_near, setup_triangles
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.scene import bake, project

from benchmarks import configs as j_configs
from chip_smoke import candidate_counts, fused_soup_bins

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import binning, raster_cuda, sampling
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight

torch.set_num_threads(2)
CENTER = ((0.5, 0.5),)
MSAA4 = tuple(JConfig(msaa=4).sample_positions)


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        c = rng.uniform(-0.9, 0.9, 2)
        sc = rng.uniform(0.05, 0.9)
        pts = c + sc * np.array([[0, 0], [1, 0.1], [0.3, 1]]) * \
            rng.uniform(0.5, 1.5, (3, 2))
        d1, d2 = pts[1] - pts[0], pts[2] - pts[0]
        if d1[0] * d2[1] - d1[1] * d2[0] < 0:
            pts = pts[::-1]
        z, w = rng.uniform(0.05, 0.95), rng.uniform(0.5, 3)
        tris.append([[p[0] * w, p[1] * w, z * w, w] for p in pts])
    return jnp.asarray(np.asarray(tris, np.float32))


def _soup_case():
    return setup_triangles(_soup(40, seed=1), 256, 128), 256, 128, 8, 128


@functools.partial(jax.jit, static_argnums=(0,))
def _flagship_shadow_setup(size, displacement=0.02):
    scene = j_app.build_scene()
    geom = bake(scene, displacement)
    anchor = jnp.array([0.0, 2.0, 0.0])
    lv = j_lights.light_view_matrix(anchor, jnp.array([0.0, 0.0, -1.0]))
    lp = j_lights.light_projection_matrix()
    clip2, _, parent = clip_near(project(geom.world, lv, lp).reshape(-1, 3, 4))
    s = setup_triangles(clip2, size, size, cull_backfaces=False)
    return s.replace(valid=s.valid & geom.cast_shadow[parent]), lv, lp, geom


def _shadow_case():
    return _flagship_shadow_setup(128)[0], 128, 128, 64, 128


def _numpy_anchored_depth(fields, width, height, tile_h, tile_w):
    """Brute-force K1 over every triangle in numpy f32, anchored planes,
    each multiply and add rounded separately (no FMA)."""
    f32 = np.float32
    py, px = np.mgrid[0:height, 0:width]
    xr = (px % tile_w).astype(f32) + f32(0.5)
    yr = (py % tile_h).astype(f32) + f32(0.5)
    ox = ((px // tile_w) * tile_w).astype(f32)
    oy = ((py // tile_h) * tile_h).astype(f32)
    zb = np.ones((height, width), f32)
    wb = np.full((height, width), -1, np.int32)
    for t, f in enumerate(np.asarray(fields)):
        def plane(k):
            cof = (f[k + 2] + f[k] * ox) + f[k + 1] * oy
            return (f[k] * xr + f[k + 1] * yr) + cof
        ok = np.full((height, width), f[15] > 0)
        for e in range(3):
            ev = plane(3 * e)
            ok &= (ev > 0) | ((ev == 0) & (f[12 + e] > 0))
        z = plane(9)
        ok &= (z >= 0) & (z <= 1)
        take = ok & ((z < zb) | ((z == zb) & (t > wb)))
        zb = np.where(take, z, zb)
        wb = np.where(take, t, wb)
    return zb, wb


def _bins(setup_j, width, height, tile_w, tile_h, pg=None):
    """The port's bins for a JAX setup, carrying the JAX visibility table
    and the port's attribute table (each vertex's value/w, where the JAX
    table holds planes) of the same setup and pass geometry."""
    setup = convert.setup_from_jax(setup_j)
    attr = (None if pg is None else binning.build_attr_fields(
        setup, convert.pass_geometry_from_jax(pg)))
    return binning.bin_triangles(
        setup, convert.tensor(jb.build_tri_fields(setup_j)), width, height,
        tile_w, tile_h, attr_fields=attr)


@pytest.mark.parametrize("case", [_soup_case, _shadow_case],
                         ids=["soup_256x128", "flagship_shadow_128"])
def test_raster_depth_plain_matches_pallas(case):
    setup_j, width, height, tile_h, tile_w = case()
    d_j, w_j, _, _ = raster_pallas.rasterize_tiles(
        setup_j, width, height, tile_h, tile_w, CENTER)
    bins = _bins(setup_j, width, height, tile_w, tile_h)
    d_p, w_p = raster_cuda.raster_depth_plain(bins, width, height, CENTER)
    w_j = np.asarray(w_j)
    assert (w_j >= 0).any()
    np.testing.assert_array_equal(w_p.numpy(), w_j)
    z_np, w_np = _numpy_anchored_depth(bins.vis, width, height, tile_h, tile_w)
    np.testing.assert_array_equal(w_np, w_j[0])
    np.testing.assert_array_equal(d_p.numpy()[0].view(np.int32),
                                  z_np.view(np.int32))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    # The CPU route of the wrapper is the twin, and launches nothing.
    before = dict(raster_cuda.LAUNCHES)
    d_w, w_w = raster_cuda.raster_depth(bins, width, height, CENTER)
    assert torch.equal(d_w, d_p) and torch.equal(w_w, w_p)
    assert raster_cuda.LAUNCHES == before


def _fused_inputs(width=96, height=72, shadow_size=128):
    cfg = JConfig(width=width, height=height, msaa=4,
                  shadow_map_size=shadow_size)
    cam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=width / height)
    setup_l, lv, lp, geom = _flagship_shadow_setup(shadow_size)
    smap = raster_pallas.rasterize_tiles(setup_l, shadow_size, shadow_size,
                                         64, 128, CENTER)[0][0]
    prep = jax.jit(j_pipe.prepare_main_pass, static_argnums=(3,))
    setup, pg = prep(geom, cam.view_matrix(), cam.projection_matrix(), cfg)
    lighting = j_lights.Lighting.default()
    funi = j_pipe._fused_uniforms(jnp.dot(lp, lv, precision="highest"), cam,
                                  jnp.array([0.0, 2.0, 0.0]), lighting.light,
                                  lighting, cfg)
    return setup, pg, funi, smap


@pytest.mark.parametrize("with_shadow", [True, False])
def test_render_fused_plain_matches_pallas(with_shadow):
    width, height = 96, 72
    setup, pg, funi, smap = _fused_inputs(width, height)
    if not with_shadow:      # a scene without casters: no map, m = 0
        smap, funi = None, funi.at[:16].set(0.0)
    rgba_j, covf_j, _ = raster_pallas.render_fused(
        setup, pg, funi, width, height, MSAA4, shadow_map=smap)
    bins = _bins(setup, width, height, 128, 8, pg)
    rgba_p, covf_p = raster_cuda.render_fused_plain(
        bins, convert.tensor(funi),
        None if smap is None else convert.tensor(smap), width, height, MSAA4)
    covf_j = np.asarray(covf_j)
    assert 0.5 < covf_j.mean() < 1.0
    np.testing.assert_array_equal(covf_p.numpy(), covf_j)
    diff = np.abs(rgba_p.numpy() - np.asarray(rgba_j)).max(axis=-1)
    c1_pixels = int((diff > 1e-5).sum())
    assert c1_pixels == 0, f"{c1_pixels} pixels differ (ROADMAP C1)"


@functools.cache
def _gbuffer_inputs(case, width=96, height=72):
    """JAX main-pass setup and pass geometry of the flagship AudioApp frame
    or of BASELINE config 4 at ``width`` x ``height`` MSAA4."""
    cfg = JConfig(width=width, height=height, msaa=4)
    if case == "flagship":
        scene, disp = j_app.build_scene(), 0.02
        cam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=width / height)
    else:
        scene, cam, _, _ = j_configs.config4_shadow_normal_map(width, height)
        disp = 0.0
    prep = jax.jit(j_pipe.prepare_main_pass, static_argnums=(3,))
    return prep(bake(scene, disp), cam.view_matrix(), cam.projection_matrix(),
                cfg)


def _numpy_weights(bins, tid, px, py, offx, offy):
    """The vertex weights of triangles ``tid`` at offsets (offx, offy) in
    pixels (px, py) in numpy f32, every multiply and add rounded on its
    own: the edge values anchored on the pixel, at least 0, e12, e20, e01
    over their sum."""
    f32 = np.float32
    f = np.asarray(bins.vis)[np.maximum(tid, 0)]
    x, y = px.astype(f32), py.astype(f32)
    e = [(f[..., 3 * k] * offx + f[..., 3 * k + 1] * offy)
         + ((f[..., 3 * k + 2] + f[..., 3 * k] * x) + f[..., 3 * k + 1] * y)
         for k in range(3)]
    e = [np.where(v < 0, f32(0), v) for v in e]
    total = (e[1] + e[2]) + e[0]
    r = f32(1) / np.where(total > 0, total, f32(1))
    return e[1] * r, e[2] * r, e[0] * r


def _numpy_interp(attr, tid, lam, k):
    """Group ``k`` of the per-vertex value/w rows of ``tid`` at weights
    ``lam``: (l0*v0 + l1*v1) + l2*v2."""
    A = np.asarray(attr)[np.maximum(tid, 0)]
    return (lam[0] * A[..., k] + lam[1] * A[..., 16 + k]) + \
        lam[2] * A[..., 32 + k]


def _numpy_gout(bins, winner, sample_offsets):
    """gout from per-sample winners in numpy f32, every multiply and add
    rounded on its own: the first covered sample's winner's groups at its
    edge weights."""
    f32 = np.float32
    win = np.asarray(winner)
    S, H, W = win.shape
    cov = win >= 0
    first = np.argmax(cov, axis=0)
    cnt = cov.sum(axis=0)
    tid = np.take_along_axis(win, first[None], 0)[0]
    offs = np.asarray(sample_offsets, f32)
    py, px = np.mgrid[0:H, 0:W]
    with np.errstate(all="ignore"):
        lam = _numpy_weights(bins, tid, px, py, offs[first, 0],
                             offs[first, 1])
        rows = [np.where(cnt > 0, _numpy_interp(bins.attr, tid, lam, k),
                         f32(0)) for k in range(15)]
    return np.stack(rows + [cnt.astype(f32)])


def _reference_gout(setup_j, pg, winner, sample_offsets, width, height):
    """The 15 attribute rows of every sample's winner at that sample by the
    JAX package's brute-force reference (``reference_cpu.
    interpolate_gbuffer``: the three vertices weighted by edge value x 1/w
    over their sum), as the kernels store them: each value over the
    sample's w, and 1/w, where w is the reference's interpolation of the
    vertices' w. f64[S, 15, H, W], zeros where uncovered."""
    win = jnp.asarray(winner)

    def interp(vattrs):
        return reference_cpu.interpolate_gbuffer(
            setup_j, win, width, height, sample_offsets, vattrs,
            pg.mat_kind, pg.mat_color, pg.tex_id,
            jnp.zeros(win.shape, jnp.float32), pg.normal_map_id)

    g = interp(pg.vattrs)
    w = interp(jnp.zeros_like(pg.vattrs).at[..., 0].set(
        1.0 / setup_j.inv_w)).world[..., 0]
    consts = jnp.stack([g.mat_kind, g.tex_id], axis=-1).astype(jnp.float32)
    vals = jnp.concatenate(
        [g.world, g.uv, g.normal, jnp.ones_like(w)[..., None], consts,
         g.mat_color, g.normal_map_id[..., None].astype(jnp.float32)],
        axis=-1)                                             # [S, H, W, 15]
    cov = np.asarray(winner) >= 0
    rows = np.moveaxis(np.asarray(vals, np.float64), -1, 1) / \
        np.where(cov, np.asarray(w, np.float64), 1.0)[:, None]
    return np.where(cov[:, None], rows, 0.0)


def _first_sample(x, winner):
    """x[S, ...rows, H, W] at each pixel's first covered sample."""
    first = np.argmax(np.asarray(winner) >= 0, axis=0)
    return np.take_along_axis(x, first[None, None], 0)[0]


# Relative to its magnitude, how far the port's attribute rows may lie from
# the JAX reference's: the reference evaluates its edge functions at the
# absolute sample position and scales them by the f32 1/area, which rounds
# by up to 4.2e-5 against the Pallas kernel, and 5.6e-5 against the port,
# on the long guard-band triangles of these scenes.
REF_TOL = 1e-4


def _near_pallas(rows_p, rows_j, ref, most):
    """Attribute rows of the port against the interpret-mode Pallas
    kernel's and the JAX reference's (``_reference_gout``), relative to
    their magnitude: within 1e-6 of the Pallas kernel's but for at most
    ``most`` values (the count measured; they lie on long guard-band
    triangles, where the Pallas kernel's planes of value/w carry the f32
    rounding of their coefficients and the port's edge weights do not,
    ROADMAP C13), and every one within REF_TOL of the reference's."""
    scale = np.maximum(np.abs(rows_j), 1.0)
    missed = int((np.abs(rows_p - rows_j) / scale > 1e-6).sum())
    assert missed <= most, f"{missed} values beyond 1e-6 of the Pallas kernel"
    off = np.abs(rows_p - ref) / np.maximum(np.abs(ref), 1.0)
    assert float(off.max()) <= REF_TOL, float(off.max())


@pytest.mark.parametrize("case,most", [("flagship", 383), ("config4", 383)])
def test_raster_gbuffer_plain_matches_pallas(case, most):
    width, height = 96, 72
    setup, pg = _gbuffer_inputs(case)
    d_j, w_j, gout_j, _ = raster_pallas.rasterize_tiles(
        setup, width, height, 8, 128, MSAA4, with_attrs=True,
        pass_geom=pg, attr_px=True)
    bins = _bins(setup, width, height, 128, 8, pg)
    gout_p, d_p, w_p = raster_cuda.raster_gbuffer_plain(
        bins, width, height, MSAA4, with_samples=True)
    gout_j, w_j = np.array(gout_j), np.asarray(w_j)
    assert gout_p.shape == (16, height, width)
    np.testing.assert_array_equal(w_p.numpy(), w_j)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)
    cnt = gout_p[binning.ROW_DEPTH].numpy()
    np.testing.assert_array_equal(cnt, gout_j[binning.ROW_DEPTH])
    assert 0.3 < (cnt > 0).mean() < 1.0
    # Bit-equal to the no-FMA numpy evaluation; near the FMA'd kernel and
    # the JAX reference.
    np.testing.assert_array_equal(
        gout_p.numpy().view(np.int32),
        _numpy_gout(bins, w_p, MSAA4).view(np.int32))
    ref = _first_sample(
        _reference_gout(setup, pg, w_j, MSAA4, width, height), w_j)
    _near_pallas(gout_p.numpy()[:15], gout_j[:15], ref, most)
    # channels_from_gout_px on the same gout: the same channels.
    ch_p = raster_cuda.channels_from_gout_px(torch.from_numpy(gout_j), 4)
    ch_j = raster_pallas.channels_from_gout_px(jnp.asarray(gout_j), 4)
    assert set(ch_p) == set(ch_j)
    for k, ref in ch_j.items():
        np.testing.assert_array_equal(ch_p[k].numpy(), np.asarray(ref),
                                      err_msg=k)
    # The CPU route of the wrapper is the twin, and launches nothing.
    before = dict(raster_cuda.LAUNCHES)
    gout_w, d_w, w_w = raster_cuda.raster_gbuffer(bins, width, height, MSAA4)
    assert torch.equal(gout_w, gout_p) and d_w is None and w_w is None
    assert raster_cuda.LAUNCHES == before


def _numpy_gout_samples(bins, winner, depth, sample_offsets):
    """Per-sample gout in numpy f32, every multiply and add rounded on its
    own: each sample's winner's groups at its edge weights there."""
    f32 = np.float32
    win, S = np.asarray(winner), len(sample_offsets)
    _, H, W = win.shape
    py, px = np.mgrid[0:H, 0:W]
    out = np.zeros((S, 16, H, W), f32)
    for s, (ox, oy) in enumerate(sample_offsets):
        with np.errstate(all="ignore"):
            lam = _numpy_weights(bins, win[s], px, py, f32(ox), f32(oy))
            for k in range(15):
                out[s, k] = np.where(win[s] >= 0,
                                     _numpy_interp(bins.attr, win[s], lam, k),
                                     f32(0))
        out[s, 15] = np.asarray(depth)[s]
    return out


@pytest.mark.parametrize("case,tile_h,samples,most", [
    ("flagship", 8, MSAA4, 1208), ("config4", 16, MSAA4, 1208),
    ("flagship", 8, CENTER, 319)],
    ids=["flagship_8x128_msaa4", "config4_16x128_msaa4",
         "flagship_8x128_msaa1"])
def test_raster_gbuffer_samples_plain_matches_pallas(case, tile_h, samples,
                                                     most):
    width, height = 96, 72
    setup, pg = _gbuffer_inputs(case)
    d_j, w_j, gout_j, _ = raster_pallas.rasterize_tiles(
        setup, width, height, tile_h, 128, samples, with_attrs=True,
        pass_geom=pg)
    bins = _bins(setup, width, height, 128, tile_h, pg)
    gout_p, d_p, w_p = raster_cuda.raster_gbuffer_samples_plain(
        bins, width, height, samples)
    gout_j, w_j = np.array(gout_j), np.array(w_j)
    S = len(samples)
    assert gout_p.shape == gout_j.shape == (S, 16, height, width)
    assert d_p.shape == w_p.shape == (S, height, width)
    np.testing.assert_array_equal(w_p.numpy(), w_j)
    assert 0.3 < (w_j >= 0).mean() < 1.0
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)
    # Row 15 is the sample's depth, clear_depth where uncovered.
    assert torch.equal(gout_p[:, binning.ROW_DEPTH], d_p)
    assert bool((d_p[w_p < 0] == 1.0).all())
    assert bool((gout_p[:, :15].permute(1, 0, 2, 3)[:, w_p < 0] == 0).all())
    # Bit-equal to the no-FMA numpy evaluation; near the FMA'd kernel and
    # the JAX reference.
    np.testing.assert_array_equal(
        gout_p.numpy().view(np.int32),
        _numpy_gout_samples(bins, w_p, d_p, samples).view(np.int32))
    _near_pallas(gout_p.numpy()[:, :15], gout_j[:, :15],
                 _reference_gout(setup, pg, w_j, samples, width, height),
                 most)
    scale = np.maximum(np.abs(gout_j[:, 15]), 1.0)
    assert float((np.abs(gout_p.numpy()[:, 15] - gout_j[:, 15])
                  / scale).max()) <= 1e-6
    # channels_from_gout on the same gout and winners: the same channels,
    # each a contiguous [S, H, W] plane (what K7 and K9 take).
    ch_p = raster_cuda.channels_from_gout(torch.from_numpy(gout_j),
                                          torch.from_numpy(w_j))
    ch_j = raster_pallas.channels_from_gout(jnp.asarray(gout_j),
                                            jnp.asarray(w_j))
    assert set(ch_p) == set(ch_j)
    for k, ref in ch_j.items():
        np.testing.assert_array_equal(ch_p[k].numpy(), np.asarray(ref),
                                      err_msg=k)
        assert ch_p[k].is_contiguous() and ch_p[k].shape == (S, height, width)
    # The CPU route of the wrapper is the twin, and launches nothing.
    before = dict(raster_cuda.LAUNCHES)
    out_w = raster_cuda.raster_gbuffer_samples(bins, width, height, samples)
    assert all(torch.equal(a, b) for a, b in zip(out_w, (gout_p, d_p, w_p)))
    assert raster_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="attribute planes"):
        raster_cuda.raster_gbuffer_samples(
            _bins(setup, width, height, 128, tile_h), width, height, samples)


@functools.cache
def _flagship_prep(width=96, height=72):
    """The port's own flagship prep at ``width`` x ``height`` MSAA4 on the
    CPU, and its 128^2 shadow map (K1's twin)."""
    cfg = RenderConfig(width=width, height=height, msaa=4,
                       shadow_map_size=128)
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=width / height)
    prep = pipeline.prepare_frame(
        audio_app.build_scene(device="cpu"), cam,
        Lighting(light=PointLight(), ambient_intensity=0.1, shininess=32.0),
        cfg, displacement=0.02,
        shadow_target=(0.0, 0.0, -1.0), device="cpu")
    smap = raster_cuda.raster_depth_plain(prep.shadow_bins, 128, 128,
                                          CENTER)[0][0]
    return prep, smap


def _small_soup(tile_w=128, tile_h=8, width=256, height=64, seed=5):
    """A few hundred triangles crowded into one tile (its list outgrows a
    staging chunk), a few scattered and big ones, exact duplicates and
    coplanar partners (z-fights); seeded."""
    return fused_soup_bins(width, height, seed, "cpu", crowd=300, small=60,
                           big=30, tile_w=tile_w, tile_h=tile_h)


@pytest.mark.parametrize("perm_seed", [0, 1])
@pytest.mark.parametrize("case", ["soup_256x64", "flagship_96x72"])
def test_render_fused_plain_is_order_free(case, perm_seed, monkeypatch):
    """K2 stages a tile's candidates in shared memory in ballot order and,
    past one chunk, chunk by chunk: the twin gives the same bits whatever
    order each tile's candidates come in."""
    prep, smap = _flagship_prep()
    if case == "soup_256x64":
        bins, width, height = _small_soup(), 256, 64
        assert int(candidate_counts(bins).max()) > \
            raster_cuda.FUSED_STAGING_CHUNK
        # Exact duplicates tie on depth wherever they cover a sample.
        rows = bins.vis[:, :15]
        assert torch.unique(rows, dim=0).shape[0] < rows.shape[0]
    else:
        bins, width, height = prep.main_bins, 96, 72
        assert int(candidate_counts(bins).max()) > 1
    args = (bins, prep.uniforms, smap, width, height, MSAA4)
    rgba, covf = raster_cuda.render_fused_plain(*args)
    assert 0.3 < float((covf > 0).float().mean()) <= 1.0
    moved = _shuffle_candidates(monkeypatch, perm_seed)
    rgba_s, covf_s = raster_cuda.render_fused_plain(*args)
    assert any(moved)
    assert torch.equal(covf_s, covf)
    assert torch.equal(rgba_s.view(torch.int32), rgba.view(torch.int32))


def _shuffle_candidates(monkeypatch, seed):
    """Permute every tile's candidates (``raster_cuda._candidates``) with a
    seeded generator; returns a list that records, per call, whether the
    permutation moved anything."""
    rng = np.random.default_rng(seed)
    original = raster_cuda._candidates
    moved = []

    def shuffled(b, tiles):
        cand = original(b, tiles)
        perm = torch.from_numpy(np.argsort(rng.random(tuple(cand.shape)),
                                           axis=1))
        out = torch.gather(cand, 1, perm)
        moved.append(not torch.equal(out, cand))
        return out

    monkeypatch.setattr(raster_cuda, "_candidates", shuffled)
    return moved


@pytest.mark.parametrize("perm_seed", [0, 1])
@pytest.mark.parametrize("case", ["soup_256x64", "config4_96x72"])
def test_raster_gbuffer_plain_is_order_free(case, perm_seed, monkeypatch):
    """K3 and K5 stage a tile's candidates as K2 does (ballot order, chunk
    by chunk past one chunk): the twin's gout, depth and winner keep their
    bits whatever order each tile's candidates come in."""
    if case == "soup_256x64":
        bins, width, height = _small_soup(), 256, 64
        assert int(candidate_counts(bins).max()) > \
            raster_cuda.FUSED_STAGING_CHUNK
        rows = bins.vis[:, :15]
        assert torch.unique(rows, dim=0).shape[0] < rows.shape[0]
    else:
        setup, pg = _gbuffer_inputs("config4")
        bins, width, height = _bins(setup, 96, 72, 128, 8, pg), 96, 72
        assert int(candidate_counts(bins).max()) > 1
    out = raster_cuda.raster_gbuffer_plain(bins, width, height, MSAA4,
                                           with_samples=True)
    assert 0.3 < float((out[0][binning.ROW_DEPTH] > 0).float().mean()) <= 1.0
    moved = _shuffle_candidates(monkeypatch, perm_seed)
    out_s = raster_cuda.raster_gbuffer_plain(bins, width, height, MSAA4,
                                             with_samples=True)
    assert any(moved)
    for a, b in zip(out_s, out):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _depth_case(case):
    """Bins, width and height of a K1 case: a crowded soup (a tile list
    longer than a staging chunk) on the shadow pass's 64x128 tiles or on
    8x128 tiles, or the flagship's 128^2 shadow pass."""
    if case == "soup_320x240_64x128":
        return _small_soup(128, 64, 320, 240), 320, 240
    if case == "soup_256x64_8x128":
        return _small_soup(), 256, 64
    return _flagship_prep()[0].shadow_bins, 128, 128


@pytest.mark.parametrize("perm_seed", [0, 1])
@pytest.mark.parametrize("case", ["soup_320x240_64x128", "soup_256x64_8x128",
                                  "flagship_shadow_128"])
def test_raster_depth_plain_is_order_free(case, perm_seed, monkeypatch):
    """K1 and K4 stage a tile's candidates as K2 does (ballot order, chunk
    by chunk past one chunk): the twin's depth and winner keep their bits
    whatever order each tile's candidates come in."""
    bins, width, height = _depth_case(case)
    if case.startswith("soup"):
        assert int(candidate_counts(bins).max()) > \
            raster_cuda.FUSED_STAGING_CHUNK
        rows = bins.vis[:, :15]
        assert torch.unique(rows, dim=0).shape[0] < rows.shape[0]
    else:
        assert int(candidate_counts(bins).max()) > 1
    d, w = raster_cuda.raster_depth_plain(bins, width, height, CENTER)
    assert 0.0 < float((w >= 0).float().mean()) < 1.0
    moved = _shuffle_candidates(monkeypatch, perm_seed)
    d_s, w_s = raster_cuda.raster_depth_plain(bins, width, height, CENTER)
    assert any(moved)
    assert torch.equal(w_s, w)
    assert torch.equal(d_s.view(torch.int32), d.view(torch.int32))


@pytest.mark.parametrize("batch,samples", [(False, CENTER), (True, MSAA4)],
                         ids=["frame_msaa1", "batch_msaa4"])
def test_raster_depth_without_winner(batch, samples):
    """``with_winner=False`` (the shadow pass's form) returns the twin's
    depth bits and None for the winner, from the wrapper and from the twin,
    on one frame (K1) and on a 2-frame batch (K4); on the CPU it launches
    nothing."""
    soups = [_small_soup(128, 64, seed=sd) for sd in (11, 12)]
    if batch:
        bins = raster_cuda.stack_bins(soups)
        wrapper = raster_cuda.raster_depth_batch
        plain = raster_cuda.raster_depth_batch_plain
    else:
        bins = soups[0]
        wrapper, plain = raster_cuda.raster_depth, raster_cuda.raster_depth_plain
    d, w = plain(bins, 256, 64, samples)
    assert d.shape == w.shape == (2,) * batch + (len(samples), 64, 256)
    assert bool((w >= 0).any())
    before = dict(raster_cuda.LAUNCHES)
    for fn in (wrapper, plain):
        d_n, w_n = fn(bins, 256, 64, samples, with_winner=False)
        assert w_n is None
        assert torch.equal(d_n.view(torch.int32), d.view(torch.int32))
    assert raster_cuda.LAUNCHES == before


@pytest.mark.parametrize("mode", [sampling.REPEAT, sampling.CLAMP])
def test_sample_bilinear_matches(mode):
    """The twin's shadow lookup: same texels and weights as the JAX
    sampler, including coordinates outside [0, 1] (wrapped or clamped)."""
    rng = np.random.default_rng(11)
    tex = rng.uniform(0, 1, (37, 53, 1)).astype(np.float32)
    u, v = rng.uniform(-1.5, 2.5, (2, 64, 48)).astype(np.float32)
    out = sampling.sample_bilinear(torch.from_numpy(tex), torch.from_numpy(u),
                                   torch.from_numpy(v), mode)
    ref = j_sampling.sample_bilinear(jnp.asarray(tex), jnp.asarray(u),
                                     jnp.asarray(v), mode)
    # 1e-6: XLA:CPU may fuse the weight multiply-adds into FMAs.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _to(bins, device):
    return binning.TileBins(**{
        k: (v.to(device) if isinstance(v, torch.Tensor) else v)
        for k, v in vars(bins).items()})


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cuda_device):
    for case in (_soup_case, _shadow_case):
        setup_j, width, height, tile_h, tile_w = case()
        bins = _to(_bins(setup_j, width, height, tile_w, tile_h), cuda_device)
        d_k, w_k = raster_cuda.raster_depth(bins, width, height, CENTER)
        d_n, w_n = raster_cuda.raster_depth(bins, width, height, CENTER,
                                            with_winner=False)
        d_p, w_p = raster_cuda.raster_depth_plain(bins, width, height, CENTER)
        torch.cuda.synchronize()
        assert torch.equal(w_k, w_p) and w_n is None
        assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
        assert torch.equal(d_n.view(torch.int32), d_p.view(torch.int32))
    # K1 on lists longer than one staging chunk (two chunks), on the shadow
    # pass's 64x128 tiles and on a ragged size with another tile shape, at
    # 1 and 4 samples, with and without the winner plane.
    for tile_w, tile_h, width, height in ((128, 64, 320, 240),
                                          (40, 24, 200, 45)):
        bins = _to(_small_soup(tile_w, tile_h, width, height), cuda_device)
        assert int(candidate_counts(bins).max()) > \
            raster_cuda.FUSED_STAGING_CHUNK
        for samples in (CENTER, MSAA4):
            d_k, w_k = raster_cuda.raster_depth(bins, width, height, samples)
            d_n, w_n = raster_cuda.raster_depth(bins, width, height, samples,
                                                with_winner=False)
            d_p, w_p = raster_cuda.raster_depth_plain(bins, width, height,
                                                      samples)
            torch.cuda.synchronize()
            assert torch.equal(w_k, w_p) and w_n is None
            assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
            assert torch.equal(d_n.view(torch.int32), d_p.view(torch.int32))
    setup, pg, funi, smap = _fused_inputs()
    bins = _to(_bins(setup, 96, 72, 128, 8, pg), cuda_device)
    u = convert.tensor(funi, cuda_device)
    sm = convert.tensor(smap, cuda_device)
    for shadow_map in (sm, None):
        rgba_k, covf_k = raster_cuda.render_fused(bins, u, shadow_map, 96, 72,
                                                  MSAA4)
        rgba_p, covf_p = raster_cuda.render_fused_plain(bins, u, shadow_map,
                                                        96, 72, MSAA4)
        torch.cuda.synchronize()
        assert torch.equal(covf_k, covf_p)
        assert float((rgba_k - rgba_p).abs().max()) <= 1e-5
    # K2 on a list longer than one staging chunk, on 8x128 tiles and on a
    # ragged size with another tile shape.
    for tile_w, tile_h, width, height in ((128, 8, 256, 64), (40, 24, 200, 45)):
        bins = _to(_small_soup(tile_w, tile_h, width, height), cuda_device)
        assert int(candidate_counts(bins).max()) > \
            raster_cuda.FUSED_STAGING_CHUNK
        rgba_k, covf_k = raster_cuda.render_fused(bins, u, sm, width, height,
                                                  MSAA4)
        rgba_p, covf_p = raster_cuda.render_fused_plain(bins, u, sm, width,
                                                        height, MSAA4)
        torch.cuda.synchronize()
        assert torch.equal(covf_k, covf_p)
        assert float((rgba_k - rgba_p).abs().max()) <= 1e-5
    for case in ("flagship", "config4"):
        setup, pg = _gbuffer_inputs(case)
        bins = _to(_bins(setup, 96, 72, 128, 8, pg), cuda_device)
        out_k = raster_cuda.raster_gbuffer(bins, 96, 72, MSAA4,
                                           with_samples=True)
        out_p = raster_cuda.raster_gbuffer_plain(bins, 96, 72, MSAA4,
                                                 with_samples=True)
        torch.cuda.synchronize()
        for k, p in zip(out_k, out_p):
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    # K3 on lists longer than one staging chunk, on 8x128 tiles and on a
    # ragged size with another tile shape; K5 on two soups as one batch.
    for tile_w, tile_h, width, height in ((128, 8, 256, 64), (40, 24, 200, 45)):
        bins = _to(_small_soup(tile_w, tile_h, width, height), cuda_device)
        out_k = raster_cuda.raster_gbuffer(bins, width, height, MSAA4,
                                           with_samples=True)
        out_p = raster_cuda.raster_gbuffer_plain(bins, width, height, MSAA4,
                                                 with_samples=True)
        torch.cuda.synchronize()
        for k, p in zip(out_k, out_p):
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    soups = [_to(_small_soup(seed=seed), cuda_device) for seed in (11, 12)]
    batch = raster_cuda.stack_bins(soups)
    g_k = raster_cuda.raster_gbuffer_batch(batch, 256, 64, MSAA4)
    g_p = raster_cuda.raster_gbuffer_batch_plain(batch, 256, 64, MSAA4)
    g_3 = torch.stack([raster_cuda.raster_gbuffer(b, 256, 64, MSAA4)[0]
                       for b in soups])
    torch.cuda.synchronize()
    assert torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
    assert torch.equal(g_k.view(torch.int32), g_3.view(torch.int32))
    for case, tile_h, samples in (("flagship", 8, MSAA4),
                                  ("config4", 16, MSAA4),
                                  ("flagship", 8, CENTER)):
        setup, pg = _gbuffer_inputs(case)
        bins = _to(_bins(setup, 96, 72, 128, tile_h, pg), cuda_device)
        out_k = raster_cuda.raster_gbuffer_samples(bins, 96, 72, samples)
        out_p = raster_cuda.raster_gbuffer_samples_plain(bins, 96, 72,
                                                         samples)
        torch.cuda.synchronize()
        for k, p in zip(out_k, out_p):
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
