"""Port parity, the samplers: the plain twins of ``sample_bilinear`` (K7) and
``sample_pyramid`` (K9) against the JAX package's reference samplers
(``sampling.sample_bilinear`` / ``sample_trilinear``) and its Pallas kernels
in interpret mode; the texture loaders; the LOD. On a CUDA device, each
CUDA kernel against its twin.

Tolerances, with their reasons:
  * against the JAX reference samplers, 1e-6 absolute: the same
    expressions, but XLA:CPU may contract the lerps' multiply-adds into
    FMAs (ROADMAP C6);
  * against the interpret-mode kernels: K9 1e-6 too, on fields where it
    samples exactly (coherent fields and seam crossings; the port never
    takes the TPU kernel's coarser-level escape, ROADMAP C7); K7 within one
    ulp of the texture width: the TPU kernel wraps ``x = u*w - 0.5`` into
    [0, w) before taking the fraction, which rounds x at the wrapped
    magnitude wherever the wrap moves it;
  * texture loaders: bit-equal (the mip box filter sums in XLA's order);
  * kernels against twins on the card: bit-equal (the same operation
    sequence, ``-fmad=false``).
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.io import textures as j_textures
from metalrenderer_tpu.raster import mip_pallas, sample_pallas
from metalrenderer_tpu.raster import sampling as j_sampling
from metalrenderer_tpu.raster import shade as j_shade

from benchmarks import configs as j_configs

from metalrenderer_tpu_torch.engine import configs as p_configs
from metalrenderer_tpu_torch.io import textures
from metalrenderer_tpu_torch.raster import mip_cuda, sample_cuda, sampling
from metalrenderer_tpu_torch.raster import shade

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = [sampling.REPEAT, sampling.CLAMP]


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_sample_bilinear_twin_matches_jax(mode, masked):
    """K7's twin vs ``sampling.sample_bilinear`` (coordinates outside
    [0, 1] too, wrapped or clamped) and vs the interpret-mode kernel
    ``sample_bilinear_tiled``, with and without a mask and ``oob_value``."""
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (48, 160)).astype(np.float32)
    u, v = rng.uniform(-0.5, 1.5, (2, 40, 136)).astype(np.float32)
    mask = rng.uniform(0, 1, (40, 136)) < 0.6 if masked else None
    out = sample_cuda.sample_bilinear_plain(
        _t(tex), _t(u), _t(v), mode, 7.0, None if mask is None else _t(mask))
    ref = j_sampling.sample_bilinear(jnp.asarray(tex)[..., None],
                                     jnp.asarray(u), jnp.asarray(v),
                                     mode)[..., 0]
    tiled = sample_pallas.sample_bilinear_tiled(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), mode,
        oob_value=7.0 if masked else None,
        mask=None if mask is None else jnp.asarray(mask))
    ref, tiled = np.asarray(ref), np.asarray(tiled)
    if masked:
        ref = np.where(mask, ref, np.float32(7.0))
        assert (out.numpy()[~mask] == 7.0).all()
    _close(out, ref)
    _close(out, tiled, atol=float(np.spacing(np.float32(tex.shape[1]))))
    # The CPU route of the wrapper is the twin, and launches nothing.
    before = dict(sample_cuda.LAUNCHES)
    w = sample_cuda.sample_bilinear(_t(tex), _t(u), _t(v), mode, 7.0,
                                    None if mask is None else _t(mask))
    assert torch.equal(w, out) and sample_cuda.LAUNCHES == before


# Inputs the K7 kernel must handle: pixel counts around its 8-pixel units
# (1, 3, 4k+1, 8k+7), coordinates at exact texel centres and edges and far
# outside [0, 1], masks all false, all true and None.
K7_CASES = {
    "n1_random": ((1, 1), "random", None),
    "n3_centres_all_true": ((1, 3), "centres", "all"),
    "n37_edges_random_mask": ((1, 37), "edges", "random"),
    "n63_far_all_false": ((1, 63), "far", "none"),
    "n63_far_random_mask": ((1, 63), "far", "random"),
    "grid40x136_mixed": ((40, 136), "mixed", None),
}


def k7_case(name, th=48, tw=64, seed=11):
    """A K7 case of ``K7_CASES``: (tex f32[th, tw], u, v f32[shape], mask
    bool[shape] or None), numpy, from a seed."""
    shape, coords, mask_kind = K7_CASES[name]
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 1, (th, tw)).astype(np.float32)
    ix = rng.integers(-2, tw + 2, shape)
    iy = rng.integers(-2, th + 2, shape)
    centres = ((ix + 0.5) / tw, (iy + 0.5) / th)        # fx = fy = 0
    edges = (ix / tw, iy / th)                          # halfway, 0 and 1
    far = (rng.choice([-37.25, 37.25], shape) + rng.uniform(-1, 1, shape),
           rng.choice([-37.25, 37.25], shape) + rng.uniform(-1, 1, shape))
    rand = rng.uniform(-0.5, 1.5, (2,) + shape)
    pick = {"random": rand, "centres": centres, "edges": edges,
            "far": far}.get(coords)
    if pick is None:                                    # mixed, per pixel
        which = rng.integers(0, 4, shape)
        pick = [np.choose(which, [c[a] for c in (rand, centres, edges, far)])
                for a in (0, 1)]
    u, v = (np.asarray(c, np.float32) for c in pick)
    mask = {None: None, "all": np.ones(shape, bool),
            "none": np.zeros(shape, bool),
            "random": rng.uniform(0, 1, shape) < 0.5}[mask_kind]
    return tex, u, v, mask


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(K7_CASES))
def test_sample_bilinear_twin_matches_jax_on_edge_cases(case, mode):
    """K7's twin vs ``sampling.sample_bilinear`` (1e-6) and vs the
    interpret-mode kernel (one ulp of the texture width) on the inputs of
    ``K7_CASES``; masked-out pixels read ``oob_value``."""
    tex, u, v, mask = k7_case(case)
    out = sample_cuda.sample_bilinear_plain(
        _t(tex), _t(u), _t(v), mode, 7.0, None if mask is None else _t(mask))
    ref = np.asarray(j_sampling.sample_bilinear(
        jnp.asarray(tex)[..., None], jnp.asarray(u), jnp.asarray(v),
        mode)[..., 0])
    tiled = np.asarray(sample_pallas.sample_bilinear_tiled(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), mode,
        oob_value=None if mask is None else 7.0,
        mask=None if mask is None else jnp.asarray(mask)))
    if mask is not None:
        ref = np.where(mask, ref, np.float32(7.0))
        assert (out.numpy()[~mask] == 7.0).all()
    assert out.shape == u.shape
    _close(out, ref)
    _close(out, tiled, atol=float(np.spacing(np.float32(tex.shape[1]))))


def _mips(seed, size=64):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (size, size, 4)).astype(np.float32)
    return j_textures.build_mipmaps(jnp.asarray(base))


def _pyramid(mips_j):
    return mip_cuda.build_pyramid(tuple(_t(m) for m in mips_j))


@pytest.mark.parametrize("mode", MODES)
def test_sample_pyramid_twin_matches_sample_trilinear(mode):
    """K9's twin vs ``sampling.sample_trilinear`` on random coordinates
    (outside [0, 1] too) and LODs (outside the chain too)."""
    mips_j = _mips(5)
    rng = np.random.default_rng(6)
    u, v = rng.uniform(-1.2, 2.2, (2, 50, 70)).astype(np.float32)
    lod = rng.uniform(-1.0, 8.0, (50, 70)).astype(np.float32)
    mask = rng.uniform(0, 1, (50, 70)) < 0.7
    out = mip_cuda.sample_pyramid_plain(_pyramid(mips_j), _t(u), _t(v),
                                        _t(lod), _t(mask), mode)
    ref = np.asarray(j_sampling.sample_trilinear(
        mips_j, jnp.asarray(u), jnp.asarray(v), jnp.asarray(lod), mode))
    # The port's own reference sampler: the JAX one's semantics.
    ref_p = sampling.sample_trilinear(tuple(_t(m) for m in mips_j), _t(u),
                                      _t(v), _t(lod), mode).numpy()
    _close(ref_p, ref)
    for c in range(3):
        _close(out[c], np.where(mask, ref[..., c], 0.0))
        _close(out[c], np.where(mask, ref_p[..., c], 0.0))
    # A single-level chain is plain bilinear.
    one = mip_cuda.sample_pyramid_plain(_pyramid(mips_j[:1]), _t(u), _t(v),
                                        torch.zeros_like(_t(u)), None, mode)
    ref1 = np.asarray(j_sampling.sample_bilinear(
        mips_j[0], jnp.asarray(u), jnp.asarray(v), mode))
    for c in range(3):
        _close(one[c], ref1[..., c])
    before = dict(mip_cuda.LAUNCHES)
    w = mip_cuda.sample_pyramid(_pyramid(mips_j), _t(u), _t(v), _t(lod),
                                _t(mask), mode)
    assert all(torch.equal(a, b) for a, b in zip(w, out))
    assert mip_cuda.LAUNCHES == before


def _field(kind, h=72, w=96):
    """uv/lod fields the Pallas K9 samples exactly: a smooth one, one that
    crosses the u = 1 seam, and one with masked-out pixels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (0.13 + xx * 0.004 + yy * 0.001).astype(np.float32)
    v = (0.21 + yy * 0.005 - xx * 0.0007).astype(np.float32)
    if kind == "seam":
        u = (u + np.float32(0.7)).astype(np.float32)     # crosses u = 1
    lod = (0.3 + xx * 0.03 + yy * 0.01).astype(np.float32)
    mask = np.ones((h, w), bool)
    if kind == "masked":
        mask = ((xx.astype(int) // 7 + yy.astype(int) // 5) % 3) != 0
    return u, v, lod, mask


@pytest.mark.parametrize("kind", ["coherent", "seam", "masked"])
def test_sample_pyramid_twin_matches_pallas(kind):
    mips_j = _mips(9)
    u, v, lod, mask = _field(kind)
    tiled = mip_pallas.sample_pyramid_tiled(
        mips_j, jnp.asarray(u), jnp.asarray(v), jnp.asarray(lod),
        jnp.asarray(mask), j_sampling.REPEAT)
    out = mip_cuda.sample_pyramid_plain(_pyramid(mips_j), _t(u), _t(v),
                                        _t(lod), _t(mask), sampling.REPEAT)
    for c in range(3):
        _close(out[c], tiled[c])
        assert (out[c].numpy()[~mask] == 0.0).all()


def k9_frame_lookups(width, height):
    """K9's twin and the interpret-mode Pallas kernel on two frames' real
    lookups, computed by the port on the CPU: BASELINE config 4's normal map
    and the grass-textured AudioApp cube's color texture. Yields (name,
    sampled pixels, pixels differing by more than 1e-6, max difference)."""
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.raster import raster_cuda
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting
    scene4, cam4, light4, cfg4 = p_configs.config4_shadow_normal_map(
        width, height, device="cpu")
    grass = audio_app.build_scene(textures=(audio_app.grass_texture(),),
                                  cube_texture_id=0, device="cpu")
    cases = (("config4_normal_map", scene4, cam4, light4, cfg4, "nmid",
              (0.0, 0.0, 0.0)),
             ("grass_cube_color", grass,
              OrbitCamera(radius=5.0, theta=2.5, phi=1.2,
                          aspect=width / height), Lighting.default(),
              RenderConfig(width=width, height=height), "texid",
              (0.0, 0.0, -1.0)))
    for name, scene, cam, light, cfg, sel, target in cases:
        cfg = cfg.replace(shadow_map_size=128)
        prep = pipeline.prepare_frame(scene, cam, light, cfg,
                                      shadow_target=target, device="cpu")
        gout = raster_cuda.raster_gbuffer(prep.main_bins, width, height,
                                          tuple(cfg.sample_positions))[0]
        ch = raster_cuda.channels_from_gout_px(gout, len(cfg.sample_positions))
        mips = scene.textures[0]
        lod = shade._texture_lod(ch["u"], ch["v"], mips[0].shape[1],
                                 mips[0].shape[0])
        mask = (ch[sel] == 0) & ch["covered"]
        out = mip_cuda.sample_pyramid_plain(mip_cuda.build_pyramid(mips),
                                            ch["u"], ch["v"], lod, mask)
        tiled = mip_pallas.sample_pyramid_tiled(
            tuple(jnp.asarray(m.numpy()) for m in mips),
            *(jnp.asarray(x.numpy()) for x in (ch["u"], ch["v"], lod, mask)))
        diff = np.max([np.abs(np.asarray(t) - o.numpy())
                       for t, o in zip(tiled, out)], axis=0)
        yield name, int(mask.sum()), int((diff > 1e-6).sum()), float(diff.max())


def test_sample_pyramid_twin_matches_pallas_on_frames():
    """On the config-4 and grass-cube frames' lookups the TPU kernel samples
    exactly everywhere (no coarser-level escape fires), so the twin agrees
    with it to 1e-6 on every pixel (ROADMAP C7 records the counts)."""
    for name, sampled, differing, _ in k9_frame_lookups(96, 72):
        assert sampled > 100, name
        assert differing == 0, (name, differing)


def test_texture_loaders_match_jax():
    grass_j = j_textures.load_texture(ROOT / "assets" / "mc_grass.png")
    grass_p = textures.load_texture(ROOT / "assets" / "mc_grass.png")
    nm_j = j_configs.config4_shadow_normal_map(32, 24)[0].textures[0]
    nm_p = p_configs.bumpy_normal_map()
    rng = np.random.default_rng(2)
    arr = (rng.uniform(0, 1, (64, 32, 3)) * 255).astype(np.uint8)
    pairs = [(grass_j, grass_p), (nm_j, nm_p),
             (j_textures.from_array(arr, flip_vertical=True),
              textures.from_array(arr, flip_vertical=True)),
             (j_textures.checkerboard(64, 4), textures.checkerboard(64, 4))]
    for mips_j, mips_p in pairs:
        assert len(mips_j) == len(mips_p)
        for a, b in zip(mips_j, mips_p):
            assert b.dtype == torch.float32 and b.shape == a.shape
            np.testing.assert_array_equal(
                b.numpy().view(np.int32), np.asarray(a).view(np.int32))
    assert len(grass_p) == 10 and len(nm_p) == 9


def test_texture_lod_matches_jax():
    """``_texture_lod`` (wrapping screen-space differences) and
    ``mip_level_from_uv_derivatives`` against the JAX package."""
    rng = np.random.default_rng(4)
    u = np.cumsum(rng.uniform(0, 0.01, (30, 40)), axis=1).astype(np.float32)
    v = np.cumsum(rng.uniform(0, 0.01, (30, 40)), axis=0).astype(np.float32)
    lod_p = shade._texture_lod(_t(u), _t(v), 256, 128)
    lod_j = j_shade._texture_lod(jnp.asarray(u), jnp.asarray(v), 256, 128)
    _close(lod_p, lod_j, atol=1e-5)
    # The last column's difference wraps around to the first.
    assert np.isfinite(lod_p.numpy()).all()
    d = [rng.normal(0, 0.01, (30, 40)).astype(np.float32) for _ in range(4)]
    m_p = sampling.mip_level_from_uv_derivatives(*map(_t, d), 64, 32)
    m_j = j_sampling.mip_level_from_uv_derivatives(*map(jnp.asarray, d),
                                                   64, 32)
    _close(m_p, m_j, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_samplers_match_twins_on_card(cuda_device):
    rng = np.random.default_rng(8)
    tex = _t(rng.uniform(0, 1, (200, 300)).astype(np.float32)).to(cuda_device)
    u, v = (_t(a).to(cuda_device) for a in
            rng.uniform(-0.5, 1.5, (2, 90, 130)).astype(np.float32))
    mask = _t(rng.uniform(0, 1, (90, 130)) < 0.5).to(cuda_device)
    for mode in MODES:
        for m in (mask, None):
            k = sample_cuda.sample_bilinear(tex, u, v, mode, 3.0, m)
            p = sample_cuda.sample_bilinear_plain(tex, u, v, mode, 3.0, m)
            torch.cuda.synchronize()
            assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    pyr = mip_cuda.build_pyramid(tuple(_t(m).to(cuda_device)
                                       for m in _mips(5)))
    lod = _t(rng.uniform(-1.0, 8.0, (90, 130)).astype(np.float32)).to(
        cuda_device)
    for mode in MODES:
        for m in (mask, None):
            k = mip_cuda.sample_pyramid(pyr, u, v, lod, m, mode)
            p = mip_cuda.sample_pyramid_plain(pyr, u, v, lod, m, mode)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(K7_CASES))
def test_sample_bilinear_kernel_on_edge_cases_on_card(cuda_device, case,
                                                      mode):
    """K7 bit-equal to its twin on ``K7_CASES``, and on views of the
    inputs that start 1, 2 and 3 floats past a 16-byte boundary (u, v and
    mask shifted together, or v alone)."""
    tex, u, v, mask = (None if a is None else _t(a).to(cuda_device)
                       for a in k7_case(case))

    def check(uu, vv, mm):
        k = sample_cuda.sample_bilinear(tex, uu, vv, mode, 7.0, mm)
        p = sample_cuda.sample_bilinear_plain(tex, uu, vv, mode, 7.0, mm)
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))

    check(u, v, mask)
    n = u.numel()
    pad = [None if a is None else torch.cat([a.new_zeros(3), a.reshape(-1)])
           for a in (u, v, mask)]
    for s in (1, 2, 3):
        uu, vv, mm = (None if a is None else a[s:s + n] for a in pad)
        assert uu.data_ptr() % 16 != 0
        check(uu, vv, mm)
        check(u.reshape(-1), vv, None if mask is None else mask.reshape(-1))


if __name__ == "__main__":
    # Pixels where the interpret-mode Pallas K9 differs from exact
    # trilinear sampling, at a given frame size:
    #   python tests/test_torch_sampling.py 1920 1080
    import sys
    for row in k9_frame_lookups(int(sys.argv[1]), int(sys.argv[2])):
        print("%s: sampled %d, differing > 1e-6: %d, max diff %.3g" % row,
              flush=True)
