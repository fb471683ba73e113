"""Sliver triangles far from the screen's origin (ROADMAP C13): the
attribute interpolation of K2/K6, K3/K5 and K3s stays bounded.

A fan of needles around an apex near x = 3837 of a 3840x8 frame, each
needle ~0.005 px^2 (the dense sphere's pole fans, BASELINE config 5, are
like it: 8e-4 px^2 at x ~ 1879), rendered through the kernels' twins on
the CPU (``render_frame``, ``render_batch``; the fused path K2/K6, the
split path K3/K5 with ``fused_shade=False``, the per-sample G-buffer K3s
with ``shading_per_pixel=False``) and held against the port's brute-force
reference backend. A plane of value/w evaluated at x ~ 3837 cancels on
such a needle, whose coefficients scale with 1/area: the frames read far
from the reference there. Weighting each vertex by its sample's edge
values over their sum keeps every weight in [0, 1], so the G-buffer's
normals, interpolated between unit vertex normals, are no longer than 1
(+1e-5 of rounding) and the frames meet the reference.

Then the dense sphere itself at a small size over a sweep of
displacements, twin against reference; and on a card the CUDA kernels
against their twins on the sliver scene, bit-equal (K2/K6 within K2's
1e-5)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from metalrenderer_tpu_torch import render_batch
from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import configs
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.raster import raster_cuda
from metalrenderer_tpu_torch.scene.lights import Lighting
from metalrenderer_tpu_torch.scene.materials import BLINN_PHONG, Material
from metalrenderer_tpu_torch.scene.mesh import from_numpy
from metalrenderer_tpu_torch.scene.scene import Instance, Scene

torch.set_num_threads(2)
W, H = 3840, 8
APEX = (3836.3, 3.7)          # screen pixels
RADIUS = 9.0                  # the needles' length, pixels
WEDGES = 50_000               # of the whole fan; needle area ~0.005 px^2
# Clip = P @ world with world = (X, Y, w): clip (SCALE X, SCALE Y, 0.5,
# w), so a vertex's screen position and 1/w are chosen directly, and a
# needle spans a few ten-thousandths of the world: its vertices' positions,
# like their normals, nearly agree, as on the sphere's pole, and the
# reference's weights (its edge values at x ~ 3837 round as much as the
# needles are wide) move its frame by rounding alone.
W_CLIP = 2.0
SCALE = 1e4
PROJ = torch.tensor([[SCALE, 0.0, 0.0, 0.0], [0.0, SCALE, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.5], [0.0, 0.0, 1.0, 0.0]])
# Frames against the reference: rounding of the shading and of the
# reference's weights (9.2e-5 on the needles).
RGBA_TOL = 5e-4


@dataclasses.dataclass(frozen=True)
class ScreenCamera:
    """A camera whose P @ V is ``PROJ``, at ``position`` for the
    specular term."""

    position: torch.Tensor = torch.tensor([0.0, 0.0, -1.0])

    def view_matrix(self):
        return torch.eye(4)

    def projection_matrix(self):
        return PROJ.clone()


def _fan_mesh(samples):
    """The needles of a fan of WEDGES around APEX that hold one of the
    ``samples`` (offsets within a pixel) of a pixel within RADIUS, with one
    neighbour on each side. Vertex normals are unit vectors that turn
    with the angle, so a needle's three differ by a ten-thousandth, as on
    the sphere's pole; every vertex has w = W_CLIP, so a needle's 1/w plane
    is flat and any sound interpolation of it reads 1 / W_CLIP."""
    ax, ay = APEX
    delta = 2.0 * math.pi / WEDGES
    ks = set()
    for py in range(H):
        for px in range(int(ax - RADIUS), W):
            for ox, oy in samples:
                dx, dy = px + ox - ax, py + oy - ay
                if 0.5 < math.hypot(dx, dy) < RADIUS - 0.5:
                    k = int(math.atan2(dy, dx) % (2.0 * math.pi) // delta)
                    ks.update((k + j) % WEDGES for j in range(-1, 2))

    def vertex(sx, sy, w, phi):
        n = np.array([0.4 * math.cos(phi), 0.4 * math.sin(phi), -1.0])
        pos = [(2.0 * sx / W - 1.0) * w / SCALE,
               (1.0 - 2.0 * sy / H) * w / SCALE, w]
        return pos, n / np.linalg.norm(n)

    pos, nrm = [], []
    for k in sorted(ks):
        t0, t1 = k * delta, (k + 1) * delta
        tri = [vertex(ax, ay, W_CLIP, 0.5 * (t0 + t1))]
        for t in (t1, t0):     # counter-clockwise in NDC: front-facing
            tri.append(vertex(ax + RADIUS * math.cos(t),
                              ay + RADIUS * math.sin(t), W_CLIP, t))
        for p, n in tri:
            pos.append(p)
            nrm.append(n)
    pos = np.asarray(pos, np.float32)
    return from_numpy(pos, np.zeros((pos.shape[0], 2), np.float32),
                      np.asarray(nrm, np.float32))


CASES = {"fused": dict(), "split": dict(fused_shade=False),
         "per_sample": dict(shading_per_pixel=False)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sliver_scene():
    cfg = RenderConfig(width=W, height=H, msaa=1, span_cap=4)
    samples = [tuple(s) for s in RenderConfig(msaa=4).sample_positions] + \
        [tuple(s) for s in cfg.sample_positions]
    scene = Scene(instances=(Instance(
        mesh=_fan_mesh(samples), model_matrix=torch.eye(4),
        material=Material(color=torch.tensor([0.8, 0.4, 0.3]),
                          kind=BLINN_PHONG)),))
    return scene, ScreenCamera(), Lighting.default(), cfg


def _needles(scene, cam, cfg):
    """The frame's setup (the reference backend's prep): how many needles
    are valid, their largest area in px^2 and their smallest screen x."""
    setup = pipeline.prepare_frame(scene, cam, Lighting.default(), cfg,
                                   backend="reference",
                                   device="cpu").main_setup
    v = setup.valid
    area = 1.0 / setup.inv_area[v]
    return int(v.sum()), float(area.max()), float(setup.aabb[v, 0].min())


def _gap(fb, ref):
    return float((fb - ref).abs().max())


@pytest.mark.parametrize("msaa", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sliver_frame_meets_the_reference(sliver_scene, case, msaa):
    """K2 (fused), K3 (split) and K3s (per-sample) twins through
    ``render_frame``: the needles covered, every pixel within RGBA_TOL of
    the reference backend's frame."""
    scene, cam, light, cfg = sliver_scene
    cfg = cfg.replace(msaa=msaa, **CASES[case])
    n, area, x0 = _needles(scene, cam, cfg)
    assert n > 100 and area < 0.02 and x0 > 3800.0
    fb, st = pipeline.render_frame(scene, cam, light, cfg, device="cpu")
    ref, st_r = pipeline.render_frame(scene, cam, light, cfg,
                                      backend="reference", device="cpu")
    assert float(st["covered_fraction"]) > 0.0
    assert float(st["covered_fraction"]) == float(st_r["covered_fraction"])
    assert _gap(fb, ref) <= RGBA_TOL, _gap(fb, ref)


@pytest.mark.parametrize("case", ["fused", "split"])
def test_sliver_batch_meets_the_reference(sliver_scene, case):
    """K6 (fused) and K5 (split) twins through ``render_batch``: each
    frame within RGBA_TOL of the reference backend's."""
    scene, cam, light, cfg = sliver_scene
    cfg = cfg.replace(**CASES[case])
    before = dict(raster_cuda.LAUNCHES)
    rgba, _ = render_batch(scene, cam, light, [0.0, 0.0], cameras=[cam, cam],
                           config=cfg, device="cpu")
    assert raster_cuda.LAUNCHES == before
    ref, _ = pipeline.render_frame(scene, cam, light, cfg,
                                   backend="reference", device="cpu")
    for f in range(2):
        assert _gap(rgba[f], ref) <= RGBA_TOL, _gap(rgba[f], ref)


def _gbuffer_normals(scene, cam, cfg, per_sample):
    """The G-buffer's interpolated normals where covered, [n, 3]: K3s's
    per sample, else K3's per pixel."""
    prep = pipeline.prepare_frame(scene, cam, Lighting.default(), cfg,
                                  device="cpu")
    samples = tuple(cfg.sample_positions)
    if per_sample:
        gout, _, win = raster_cuda.raster_gbuffer_samples_plain(
            prep.main_bins, W, H, samples)
        ch = raster_cuda.channels_from_gout(gout, win)
    else:
        gout, _, _ = raster_cuda.raster_gbuffer_plain(prep.main_bins, W, H,
                                                      samples)
        ch = raster_cuda.channels_from_gout_px(gout, len(samples))
    cov = ch["covered"]
    return torch.stack([ch["nx"][cov], ch["ny"][cov], ch["nz"][cov]], -1)


@pytest.mark.parametrize("per_sample", [False, True], ids=["k3", "k3s"])
@pytest.mark.parametrize("msaa", [1, 4])
def test_sliver_normals_stay_unit(sliver_scene, per_sample, msaa):
    """Every covered G-buffer normal, interpolated between unit vertex
    normals with weights in [0, 1], is no longer than 1 + 1e-5, and no
    shorter than the fan's vertex normals allow."""
    scene, cam, _, cfg = sliver_scene
    n = _gbuffer_normals(scene, cam, cfg.replace(msaa=msaa), per_sample)
    length = torch.linalg.vector_norm(n, dim=-1)
    assert n.shape[0] > 50
    assert float(length.max()) <= 1.0 + 1e-5, float(length.max())
    assert float(length.min()) >= 0.9, float(length.min())


def test_sliver_weights_lie_in_unit_interval(sliver_scene):
    """The twin's weights at every covered pixel: each in [0, 1] within
    rounding, and they sum to 1 within rounding."""
    scene, cam, _, cfg = sliver_scene
    prep = pipeline.prepare_frame(scene, cam, Lighting.default(), cfg,
                                  device="cpu")
    bins = prep.main_bins
    samples = tuple(cfg.sample_positions)
    xr, yr = raster_cuda._tile_pixel_grid(bins, samples, "cpu")
    tiles = torch.arange(bins.ntx * bins.nty)
    _, wb = raster_cuda._visibility_plain(bins, tiles, xr, yr, 1.0)
    cnt, lam, _ = raster_cuda._first_covered(bins, tiles, wb, samples)
    cov = cnt > 0
    lam = torch.stack([x[cov] for x in lam])
    assert lam.shape[1] > 50
    eps = 4 * torch.finfo(torch.float32).eps
    assert float(lam.min()) >= 0.0 and float(lam.max()) <= 1.0 + eps
    assert float((lam.sum(dim=0) - 1.0).abs().max()) <= eps


@pytest.mark.parametrize("displacement", [0.0, 0.0125, 0.025, 0.0375,
                                          0.040847379714250565, 0.05])
def test_dense_sphere_sweep_meets_the_reference(displacement):
    """BASELINE config 5's dense sphere at 20,000 triangles and 640x360 over
    displacements in [0, 0.05]: the K2 twin's frame within RGBA_TOL of the
    reference backend's at every pixel."""
    scene, cam, light, cfg = configs.config5_animated_high_poly(
        target_tris=20_000, width=640, height=360, device="cpu")
    fb, st = pipeline.render_frame(scene, cam, light, cfg,
                                   displacement=displacement, device="cpu")
    ref, st_r = pipeline.render_frame(scene, cam, light, cfg,
                                      displacement=displacement,
                                      backend="reference", device="cpu")
    assert 0.1 < float(st["covered_fraction"]) < 1.0
    assert float(st["covered_fraction"]) == float(st_r["covered_fraction"])
    assert _gap(fb, ref) <= RGBA_TOL, _gap(fb, ref)


@pytest.mark.cuda
def test_sliver_kernels_equal_their_twins(sliver_scene, cuda_device):
    """On a card: K2, K3 and K3s on the sliver scene's bins, and K6 and K5
    on a 2-frame batch of them, against their twins: K3, K5, K3s bit-equal,
    K2 and K6 within K2's 1e-5 (IEEE division, sqrt and powf), covered
    fractions equal."""
    scene, cam, light, cfg = sliver_scene
    dev = cuda_device
    samples = tuple(cfg.sample_positions)
    prep = pipeline.prepare_frame(scene, cam, light, cfg, device=dev)
    bins, uni = prep.main_bins, prep.uniforms
    cpu_bins = dataclasses.replace(
        bins, **{f.name: getattr(bins, f.name).cpu()
                 for f in dataclasses.fields(bins)
                 if isinstance(getattr(bins, f.name), torch.Tensor)})
    rgba, covf = raster_cuda.render_fused(bins, uni, None, W, H, samples)
    rgba_p, covf_p = raster_cuda.render_fused_plain(cpu_bins, uni.cpu(), None,
                                                    W, H, samples)
    assert torch.equal(covf.cpu(), covf_p) and float(covf_p.sum()) > 0
    assert float((rgba.cpu() - rgba_p).abs().max()) <= 1e-5
    gout, _, _ = raster_cuda.raster_gbuffer(bins, W, H, samples)
    gout_p, _, _ = raster_cuda.raster_gbuffer_plain(cpu_bins, W, H, samples)
    assert torch.equal(gout.cpu(), gout_p)
    g_s, d_s, w_s = raster_cuda.raster_gbuffer_samples(bins, W, H, samples)
    g_sp, d_sp, w_sp = raster_cuda.raster_gbuffer_samples_plain(
        cpu_bins, W, H, samples)
    assert torch.equal(g_s.cpu(), g_sp) and torch.equal(w_s.cpu(), w_sp)
    batch = raster_cuda.stack_bins([bins, bins])
    cpu_batch = raster_cuda.stack_bins([cpu_bins, cpu_bins])
    uni2 = torch.stack([uni, uni])
    r6, c6 = raster_cuda.render_fused_batch(batch, uni2, None, W, H, samples)
    r6p, c6p = raster_cuda.render_fused_batch_plain(cpu_batch, uni2.cpu(),
                                                    None, W, H, samples)
    assert torch.equal(c6.cpu(), c6p)
    assert float((r6.cpu() - r6p).abs().max()) <= 1e-5
    assert torch.equal(r6[0], rgba) and torch.equal(r6[1], rgba)
    g5 = raster_cuda.raster_gbuffer_batch(batch, W, H, samples)
    g5p = raster_cuda.raster_gbuffer_batch_plain(cpu_batch, W, H, samples)
    assert torch.equal(g5.cpu(), g5p)
