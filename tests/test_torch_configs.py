"""Port parity, BASELINE configs 2, 3 and 5 (``engine/configs.py``): whole
frames of the port (the kernels' plain twins on the CPU) against the JAX
``backend="reference"`` oracle on the JAX package's own builders
(``benchmarks/configs.py``), at the sizes of ``tests/test_configs.py``.

Bars: >= 40 dB (the BASELINE.md bar), covered fractions within 1e-6, the
triangle, cull and big-list counts equal. The frames differ from the JAX
reference by the prep's rounding (ROADMAP C9): XLA:CPU contracts the
vertex stage's and the setup's multiply-adds into FMAs, the port rounds
each op, and a pixel near an edge or a highlight moves. Measured at these
sizes: 3.99e-4 (config 2), 4.11e-4 (config 3), 2.69e-5 and 3.93e-5
(config 5 at displacement 0 and 0.4) in rgba at most; the tests hold 5e-4
and 5e-5. The JAX scenes carried across by ``convert`` render the port's
frames bit for bit (config 2 with its model matrices carried across too:
its rotations take cos, sin and a norm, which XLA:CPU and torch round up to
a few ulps apart, within 1e-6; with the port's own matrices the frame
stays within 1e-4 of it, measured 9.27e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

import metalrenderer_tpu as mr
from metalrenderer_tpu.io import obj as j_obj

from benchmarks import configs as j_configs

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.engine import configs
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import binning, raster_cuda
from metalrenderer_tpu_torch.raster.geometry import TriangleSetup

torch.set_num_threads(2)


def _psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _small(cfg, w=128, h=96):
    """tests/test_configs.py's ``_small``: 128x96, one sample."""
    return cfg.replace(width=w, height=h, msaa=1,
                       shadow_map_size=min(cfg.shadow_map_size, 128))


def _check_against_jax(port, jax_side, cfg, bound, displacement=0.0):
    """Render the port's scene and the JAX reference of the JAX scene;
    return the port's (frame, stats) and the JAX scene, camera, lighting."""
    scene, cam, lighting = port
    js, jcam, jl, jcfg = jax_side
    jcam = jcam.replace(aspect=cfg.width / cfg.height)
    jcfg = jcfg.replace(width=cfg.width, height=cfg.height, msaa=cfg.msaa,
                        shadow_map_size=cfg.shadow_map_size)
    cam = dataclasses.replace(cam, aspect=cfg.width / cfg.height)
    before = dict(raster_cuda.LAUNCHES)
    fb, st = pipeline.render_frame(scene, cam, lighting, cfg,
                                   displacement=displacement, device="cpu")
    assert raster_cuda.LAUNCHES == before           # CPU: the twins ran
    fb_j, st_j = mr.render(js, jcam, jl, jcfg, displacement=displacement,
                           backend="reference")
    fb_j = np.asarray(fb_j)
    assert fb.shape == (cfg.height, cfg.width, 4) and torch.isfinite(fb).all()
    assert _psnr(fb.numpy(), fb_j) >= 40.0
    assert float(np.abs(fb.numpy() - fb_j).max()) <= bound
    assert abs(float(st["covered_fraction"])
               - float(st_j["covered_fraction"])) <= 1e-6
    assert 0.05 < float(st["covered_fraction"]) < 1.0
    for k in ("num_triangles", "culled_triangles", "big_dropped"):
        assert int(st[k]) == int(st_j[k]), k
    assert "shadow_big_dropped" not in st           # nothing receives
    return fb, st, (js, jcam, jl)


def _converted(jax_scene, jcam, jl, cfg, displacement=0.0, matrices=None):
    scene = convert.scene_from_jax(jax_scene)
    if matrices is not None:
        scene = dataclasses.replace(scene, instances=tuple(
            dataclasses.replace(i, model_matrix=m)
            for i, m in zip(scene.instances, matrices)))
    return pipeline.render_frame(scene, convert.camera_from_jax(jcam),
                                 convert.lighting_from_jax(jl), cfg,
                                 displacement=displacement, device="cpu")


def test_config2_matches_jax_reference():
    """24 cubes and spheres cut to 8 (tests/test_configs.py's size): the
    fused path with no shadow map."""
    scene, cam, lighting, cfg = configs.config2_multi_mesh(n_objects=8,
                                                           device="cpu")
    assert cfg.msaa == 4 and (cfg.width, cfg.height) == (1920, 1080)
    small = _small(cfg)
    jax_side = j_configs.config2_multi_mesh(n_objects=8)
    fb, st, (js, jcam, jl) = _check_against_jax(
        (scene, cam, lighting), jax_side, small, 5e-4)
    assert len(scene.instances) == 9 and not scene.textures
    prep = pipeline.prepare_frame(scene, cam, lighting, small, device="cpu")
    assert prep.fused and prep.shadow_bins is None
    # The seeded transforms: the same draws in the same order as JAX.
    for i, ji in zip(scene.instances, js.instances):
        np.testing.assert_allclose(i.model_matrix.numpy(),
                                   np.asarray(ji.model_matrix), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(i.material.color.numpy(),
                                      np.asarray(ji.material.color))
    # The JAX scene carried across, with the port's matrices in it, renders
    # the same frame bit for bit; with the JAX package's matrices it is
    # within the ulps of its rotations.
    fb_c, st_c = _converted(js, jcam, jl, small,
                            matrices=[i.model_matrix
                                      for i in scene.instances])
    assert torch.equal(fb_c, fb)
    assert all(torch.equal(st_c[k], st[k]) for k in st)
    fb_c, st_c = _converted(js, jcam, jl, small)
    assert float((fb_c - fb).abs().max()) <= 1e-4
    assert abs(float(st_c["covered_fraction"])
               - float(st["covered_fraction"])) <= 1e-6


def test_config3_matches_jax_reference(tmp_path, monkeypatch):
    """The 5,000-triangle asset through the OBJ file (the port's cache in
    ``tmp_path``; the JAX builder reads the same file with its loader, not
    its own cache under benchmarks/): the split path, K3 and K9 twins."""
    scene, cam, lighting, cfg = configs.config3_high_poly(
        target_tris=5000, cache_dir=tmp_path, device="cpu")
    path = configs.obj_asset_path(5000, tmp_path)
    assert path.parent == tmp_path and path.suffix == ".obj"
    assert cfg.msaa == 1 and cfg.span_cap == 4
    monkeypatch.setattr(j_configs, "_obj_asset_mesh",
                        lambda n: j_obj.load_obj(str(path)))
    small = _small(cfg)
    fb, st, (js, jcam, jl) = _check_against_jax(
        (scene, cam, lighting), j_configs.config3_high_poly(target_tris=5000),
        small, 5e-4)
    assert int(st["num_triangles"]) == 4900
    prep = pipeline.prepare_frame(scene, cam, lighting, small, device="cpu")
    assert not prep.fused and len(prep.textures[0]) == 10   # 512^2 mips
    fb_c, st_c = _converted(js, jcam, jl, small)
    assert torch.equal(fb_c, fb)
    assert all(torch.equal(st_c[k], st[k]) for k in st)


@pytest.mark.parametrize("displacement", [0.0, 0.4])
def test_config5_matches_jax_reference(displacement):
    """The displaced sphere cut to 2,000 triangles at 128x64 (tests/
    test_configs.py's size): the fused path at one sample, no shadow map."""
    scene, cam, lighting, cfg = configs.config5_animated_high_poly(
        target_tris=2000, width=128, height=64, device="cpu")
    assert cfg.msaa == 1 and cfg.span_cap == 4
    jax_side = j_configs.config5_animated_high_poly(target_tris=2000,
                                                    width=128, height=64)
    fb, st, (js, jcam, jl) = _check_against_jax(
        (scene, cam, lighting), jax_side, cfg, 5e-5, displacement)
    fb_c, st_c = _converted(js, jcam, jl, cfg, displacement)
    assert torch.equal(fb_c, fb)
    assert all(torch.equal(st_c[k], st[k]) for k in st)
    # The mesh is JAX's, bit for bit.
    for f in ("positions", "uvs", "normals"):
        np.testing.assert_array_equal(
            getattr(scene.instances[0].mesh, f).numpy(),
            np.asarray(getattr(js.instances[0].mesh, f)))


def test_config5_displacement_moves_the_frame():
    scene, cam, lighting, cfg = configs.config5_animated_high_poly(
        target_tris=2000, width=128, height=64, device="cpu")
    fb0, st0 = pipeline.render_frame(scene, cam, lighting, cfg, device="cpu")
    fb1, st1 = pipeline.render_frame(scene, cam, lighting, cfg,
                                     displacement=0.4, device="cpu")
    assert float(st1["covered_fraction"]) > float(st0["covered_fraction"])
    assert not torch.equal(fb0, fb1)


def test_bin_triangles_refuses_tids_past_f32():
    """``vis`` carries each tid as f32, exact below 2^24: a pass with that
    many triangles raises before anything is built (a fake shape: the
    setup's tensors are views of one element)."""
    def setup(t):
        one = torch.zeros(1)
        return TriangleSetup(
            valid=torch.ones(1, dtype=torch.bool).expand(t),
            screen=one.expand(t, 3, 2), z=one.expand(t, 3),
            inv_w=one.expand(t, 3), edge=one.expand(t, 3, 3),
            top_left=torch.zeros(1, dtype=torch.bool).expand(t, 3),
            inv_area=one.expand(t), aabb=one.expand(t, 4))
    assert binning.MAX_TRIANGLES == 2 ** 24
    for t in (2 ** 24, 2 ** 24 + 5):
        with pytest.raises(ValueError, match="exact only below"):
            binning.bin_triangles(setup(t), torch.zeros(1).expand(t, 17),
                                  64, 64, 128, 8)
    # Below the limit it bins (every triangle's AABB is the origin pixel).
    bins = binning.bin_triangles(setup(3), torch.zeros(3, 17), 64, 64, 128, 8)
    assert int(bins.tile_offsets[-1]) == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _twins_agree_fused(prep, cfg):
    samples = tuple(cfg.sample_positions)
    mb = prep.main_bins
    r_k, c_k = raster_cuda.render_fused(mb, prep.uniforms, None, cfg.width,
                                        cfg.height, samples)
    r_p, c_p = raster_cuda.render_fused_plain(mb, prep.uniforms, None,
                                              cfg.width, cfg.height, samples)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p)
    assert float((r_k - r_p).abs().max()) <= 1e-5
    assert float(c_k.mean()) > 0.05


@pytest.mark.cuda
def test_config_kernels_match_twins_on_card(cuda_device, tmp_path):
    """K2 with no shadow map at 4 samples (config 2) and at 1 (config 5),
    and K3 at 1 sample (config 3), on the configs' own bins at 320x240:
    covered fractions equal and rgba within 1e-5 (K2), gout bit-equal (K3)."""
    scene, cam, light, cfg = configs.config2_multi_mesh(
        n_objects=8, width=320, height=240, device=cuda_device)
    prep = pipeline.prepare_frame(scene, cam, light, cfg, device=cuda_device)
    assert prep.fused and prep.shadow_bins is None and cfg.msaa == 4
    _twins_agree_fused(prep, cfg)
    scene, cam, light, cfg = configs.config5_animated_high_poly(
        target_tris=20_000, width=320, height=240, device=cuda_device)
    for d in (0.0, 0.4):
        prep = pipeline.prepare_frame(scene, cam, light, cfg, displacement=d,
                                      device=cuda_device)
        assert prep.fused and cfg.msaa == 1
        _twins_agree_fused(prep, cfg)
    scene, cam, light, cfg = configs.config3_high_poly(
        target_tris=20_000, width=320, height=240, cache_dir=tmp_path,
        device=cuda_device)
    prep = pipeline.prepare_frame(scene, cam, light, cfg, device=cuda_device)
    samples = tuple(cfg.sample_positions)
    g_k, d_k, w_k = raster_cuda.raster_gbuffer(prep.main_bins, 320, 240,
                                               samples, with_samples=True)
    g_p, d_p, w_p = raster_cuda.raster_gbuffer_plain(prep.main_bins, 320, 240,
                                                     samples,
                                                     with_samples=True)
    torch.cuda.synchronize()
    assert torch.equal(w_k, w_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
    assert int((g_k[binning.ROW_DEPTH] > 0).sum()) > 0
