"""The main pass's geometry front end (``raster/setup_cuda.py``): the CUDA
kernel ``csrc/setup.cu`` and its plain twin, the eager chain.

On the CPU: the twin against the chain composed step by step (projection,
``clip_near`` with attributes, ``guard_clip_xy``, ``setup_triangles``, the
material gathers, ``build_tri_fields``, ``build_attr_fields`` and the
stats, as the pipeline composed them before the kernel), bit for bit, on
the flagship, the dense sphere (BASELINE config 5, small), seeded soups
with every near-clip count and both cull settings, and guard-band soups
whose oversize triangles fill the side list or overflow it; the wrapper's
checks (device, dtype, shape, contiguity) and its slots, S = 2T + 5 cap,
with a stand-in library; and that the CPU and the reference backend never
launch it.

On the card (``-m cuda``, no JAX: ``python -m pytest --noconftest
tests/test_torch_setup_kernel.py -m cuda``): the kernel against the plain
chain on the card, bit for bit on ``vis``, ``attr``, ``aabb``, ``valid``
and every stat, on config 5 at 3840x2160 (four displacements, one of them
the once-faulty sliver case), the flagship frame and the soups; and the
graphed prep against the op-by-op prep, with the launch counter.
"""
import ctypes

import numpy as np
import pytest
import torch

from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app, configs
from metalrenderer_tpu_torch.math import transforms
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.passes import prep as frame_prep
from metalrenderer_tpu_torch.raster import setup_cuda
from metalrenderer_tpu_torch.raster.binning import (build_attr_fields,
                                                    build_tri_fields)
from metalrenderer_tpu_torch.raster.geometry import (clip_near,
                                                     guard_clip_xy,
                                                     setup_triangles)
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting
from metalrenderer_tpu_torch.scene.scene import PackedGeometry, bake

torch.set_num_threads(2)
SLIVER = 0.040847379714250565      # config 5's once-faulty displacement
TABLES = ("vis", "attr", "aabb", "valid")


def soup(n, seed, n_oversize=0):
    """A seeded triangle soup before a perspective camera at the origin
    (looking down -z, near 0.1): triangles straddle the near plane (every
    near-clip count) and the eye plane (w <= 0); ``n_oversize`` of them,
    spread over the soup, lie just beyond the near plane hundreds of units
    wide, far outside the 32768-pixel guard band."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                  rng.uniform(-2.0, 0.6, n)], -1)[:, None]
    v = c + rng.uniform(0.02, 0.8, (n, 1, 1)) * rng.uniform(-1, 1, (n, 3, 3))
    if n_oversize:
        k = np.sort(rng.choice(n, n_oversize, replace=False))
        v[k] = np.stack([rng.uniform(-300, 300, (n_oversize, 3)),
                         rng.uniform(-200, 200, (n_oversize, 3)),
                         rng.uniform(-0.4, -0.12, (n_oversize, 3))], -1)
    nrm = rng.normal(size=(3 * n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype))
    return PackedGeometry(
        world=t(v.reshape(-1, 3), np.float32),
        uvs=t(rng.uniform(0, 1, (3 * n, 2)), np.float32),
        normals=t(nrm, np.float32),
        mat_kind=t(rng.integers(0, 3, n), np.int32),
        mat_color=t(rng.uniform(0, 1, (n, 3)), np.float32),
        tex_id=t(rng.integers(-1, 3, n), np.int32),
        normal_map_id=t(rng.integers(-1, 2, n), np.int32),
        cast_shadow=torch.ones(n, dtype=torch.bool))


def _vp(cam):
    return transforms.matmul(cam.projection_matrix(), cam.view_matrix())


def _flagship(w, h, disp, theta=2.5):
    cam = OrbitCamera(radius=5.0, theta=theta, phi=1.2, aspect=w / h)
    cfg = RenderConfig(width=w, height=h, msaa=4, shadow_map_size=64)
    return bake(audio_app.build_scene(device="cpu"), disp), _vp(cam), cfg


def _sphere(disp, tris, w, h):
    scene, cam, _, cfg = configs.config5_animated_high_poly(
        target_tris=tris, width=w, height=h, device="cpu")
    return bake(scene, disp), _vp(cam), cfg


def _soup_case(seed, cull, cap, n=1500, n_oversize=0):
    cfg = RenderConfig(width=160, height=96, msaa=1, cull_backfaces=cull,
                       xyclip_capacity=cap)
    vp = transforms.perspective_rh(np.pi / 3, 160 / 96, 0.1, 100.0)
    return soup(n, seed, n_oversize), vp, cfg


# (name, builder of (geometry, P @ V, config)) at CPU-test sizes.
CASES = {
    "flagship": lambda: _flagship(320, 240, 0.05),
    "flagship_blown_up": lambda: _flagship(320, 240, 5.0, theta=2.2),
    "sphere_d0": lambda: _sphere(0.0, 3000, 384, 216),
    "sphere_sliver": lambda: _sphere(SLIVER, 3000, 384, 216),
    "soup_cull": lambda: _soup_case(0, True, 64),
    "soup_nocull": lambda: _soup_case(1, False, 64),
    "soup_guard_off": lambda: _soup_case(2, False, 0),
    "guard_under_cap": lambda: _soup_case(3, True, 64, n_oversize=40),
    "guard_full": lambda: _soup_case(4, False, 64, n_oversize=64),
    "guard_overflow": lambda: _soup_case(5, False, 64, n_oversize=200),
    "guard_overflow_cap8": lambda: _soup_case(6, True, 8, n_oversize=30),
}


def _chain(geom, vp, config):
    """The main pass as the pipeline composed it before the kernel."""
    clip = transforms.transform_points(vp, geom.world).reshape(-1, 3, 4)
    attrs = torch.cat([geom.world, geom.uvs, geom.normals],
                      dim=-1).reshape(-1, 3, 8)
    clip2, attrs2, parent = clip_near(clip, attrs)
    zero = torch.zeros((), dtype=torch.int32)
    gstats = {"xyclip_triangles": zero, "xyclip_dropped": zero}
    if config.xyclip_capacity > 0:
        clip2, attrs2, parent, gstats = guard_clip_xy(
            clip2, attrs2, parent, config.width, config.height,
            cap=config.xyclip_capacity, guard_px=config.guard_band_px)
    setup = setup_triangles(clip2, config.width, config.height,
                            cull_backfaces=config.cull_backfaces,
                            near_eps=config.near_eps)
    p = parent.to(torch.int64)
    pg = setup_cuda.PassGeometry(
        vattrs=attrs2, mat_kind=geom.mat_kind[p], mat_color=geom.mat_color[p],
        tex_id=geom.tex_id[p], normal_map_id=geom.normal_map_id[p])
    stats = {"culled_triangles": (~setup.valid).sum().to(torch.int32),
             **gstats,
             "max_screen_coord": torch.amax(torch.where(
                 setup.valid[:, None, None], torch.abs(setup.screen),
                 torch.zeros_like(setup.screen)))}
    return setup_cuda.MainTables(
        vis=build_tri_fields(setup), attr=build_attr_fields(setup, pg),
        aabb=setup.aabb, valid=setup.valid, stats=stats)


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8).cpu()


def _assert_bit_equal(got, want):
    for k in TABLES:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert torch.equal(_bits(a), _bits(b)), k
    assert list(got.stats) == list(want.stats)
    for k, v in want.stats.items():
        assert got.stats[k].dtype == v.dtype, k
        assert torch.equal(_bits(got.stats[k]), _bits(v)), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_is_the_chain(name):
    geom, vp, cfg = CASES[name]()
    got = setup_cuda.main_pass_tables_plain(geom, vp, cfg)
    _assert_bit_equal(got, _chain(geom, vp, cfg))
    n = geom.num_triangles
    cap = min(cfg.xyclip_capacity, 2 * n)
    assert got.vis.shape == (2 * n + 5 * cap, 17)
    if name.startswith("guard_overflow"):
        assert int(got.stats["xyclip_dropped"]) > 0
    if name.startswith("guard_full"):
        assert int(got.stats["xyclip_triangles"]) == cap


def test_soups_reach_every_near_clip_count():
    """The soups exercise clip_near's four patterns and w <= 0."""
    geom, vp, _ = CASES["soup_cull"]()
    clip = transforms.transform_points(vp, geom.world).reshape(-1, 3, 4)
    counts = torch.bincount((clip[..., 2] >= 0).sum(-1), minlength=4)
    assert (counts > 50).all()
    assert bool((clip[..., 3] <= 0).any())


class _FakeLib:
    """Stands in for the CUDA library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(args, stream):
            a = args._obj
            self.calls.append((name, a.n_tris, a.cap, a.cull, a.half_w,
                               a.near_eps))
            return 0
        return launch


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(setup_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(setup_cuda._build, "stream",
                        lambda device: ctypes.c_void_p(0))
    setup_cuda.reset_launch_counts()
    return lib


@pytest.mark.parametrize("name", ["flagship", "soup_guard_off",
                                  "guard_overflow_cap8"])
def test_wrapper_slots_and_launches(fake_lib, name):
    """S = 2T + 5 cap (cap = min(xyclip_capacity, 2T)); one launch with the
    guard band off, three with it on; the stats in the plain twin's order
    and types."""
    geom, vp, cfg = CASES[name]()
    got = setup_cuda._main_pass_tables_kernel(geom, vp.contiguous(), cfg)
    want = setup_cuda.main_pass_tables_plain(geom, vp, cfg)
    n = geom.num_triangles
    cap = min(cfg.xyclip_capacity, 2 * n)
    for k in TABLES:
        assert getattr(got, k).shape == getattr(want, k).shape, k
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.vis.shape[0] == 2 * n + 5 * cap
    assert list(got.stats) == list(want.stats)
    assert [v.dtype for v in got.stats.values()] == [
        v.dtype for v in want.stats.values()]
    names = ["mr_setup_tables"] + (
        ["mr_setup_fans", "mr_setup_fixup"] if cap else [])
    assert [c[0] for c in fake_lib.calls] == names
    assert all(c[1:] == (n, cap, int(cfg.cull_backfaces), 0.5 * cfg.width,
                         pytest.approx(cfg.near_eps)) for c in fake_lib.calls)
    assert setup_cuda.LAUNCHES == {
        "setup_tables": 1, "setup_fans": int(cap > 0),
        "setup_fixup": int(cap > 0)}


def _with(geom, **kw):
    return PackedGeometry(**{**geom.__dict__, **kw})


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity",
                                   "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib, fault):
    geom, vp, cfg = CASES["flagship"]()
    if fault == "dtype":
        geom = _with(geom, mat_kind=geom.mat_kind.to(torch.int64))
    elif fault == "shape":
        geom = _with(geom, uvs=geom.uvs[:-3])
    elif fault == "contiguity":
        geom = _with(geom, normals=geom.normals.T.contiguous().T)
    else:
        vp = vp.to("meta")
    with pytest.raises(ValueError):
        setup_cuda._main_pass_tables_kernel(geom, vp, cfg)
    assert fake_lib.calls == []


@pytest.mark.parametrize("backend", ["kernels", "reference"])
def test_cpu_and_reference_run_the_chain(fake_lib, backend):
    """On the CPU, and for the reference backend, the prep runs the plain
    chain: nothing launches."""
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=2.0)
    prep = pipeline.prepare_frame(
        audio_app.build_scene(device="cpu"), cam, Lighting.default(),
        RenderConfig(width=128, height=64, msaa=4, shadow_map_size=64),
        ShadowConfig(), displacement=0.05, shadow_target=(0.0, 0.0, -1.0),
        backend=backend, device="cpu")
    assert fake_lib.calls == []
    assert setup_cuda.LAUNCHES == dict.fromkeys(setup_cuda.LAUNCHES, 0)
    assert isinstance(prep, pipeline.ReferencePrep) == (
        backend == "reference")


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA C++)")
    return torch.device("cuda")


def _on(dev, geom, vp):
    return PackedGeometry(**{k: v.to(dev) for k, v in geom.__dict__.items()}
                          ), vp.to(dev)


CARD_CASES = {
    **{f"sphere4k_d{d}": (lambda d=d: _sphere(d, 1_000_000, 3840, 2160))
       for d in (0.0, 0.025, 0.05, SLIVER)},
    "flagship1080": lambda: _flagship(1920, 1080, 0.05),
    **{k: v for k, v in CASES.items() if not k.startswith("sphere")},
    "soup_big_cull": lambda: _soup_case(7, True, 64, n=200_000,
                                        n_oversize=20),
    "soup_big_nocull": lambda: _soup_case(8, False, 64, n=200_000,
                                          n_oversize=500),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_equals_the_plain_chain_on_card(cuda_device, name):
    geom, vp, cfg = CARD_CASES[name]()
    geom, vp = _on(cuda_device, geom, vp)
    before = dict(setup_cuda.LAUNCHES)
    got = setup_cuda.main_pass_tables(geom, vp, cfg)
    assert setup_cuda.LAUNCHES["setup_tables"] == before["setup_tables"] + 1
    _assert_bit_equal(got, setup_cuda.main_pass_tables_plain(geom, vp, cfg))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sphere", "flagship"])
def test_graphed_prep_equals_op_by_op_on_card(cuda_device, name):
    """The kernel inside the prep graph: the captured and the replayed
    preps' tables equal the op-by-op prep's, and every card prep that runs
    its ops (op by op, the capture's warm-up and capture) launches it."""
    if name == "sphere":
        scene, cam, light, cfg = configs.config5_animated_high_poly(
            device=cuda_device)
        target, disps = (0.0, 0.0, 0.0), (0.0, 0.025, SLIVER)
    else:
        scene = audio_app.build_scene(device=cuda_device)
        cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=16 / 9)
        light, cfg = Lighting.default(), RenderConfig(width=1920,
                                                      height=1080)
        target, disps = (0.0, 0.0, -1.0), (0.0, 0.05, 5.0)
    frame_prep.PREP_GRAPH.clear()
    setup_cuda.reset_launch_counts()
    for k, d in enumerate(disps):
        with pipeline._handed_over():
            got = pipeline.prepare_frame(scene, cam, light, cfg,
                                         displacement=d,
                                         shadow_target=target,
                                         device=cuda_device)
        assert got.static == (k > 0)
        want = frame_prep.prepare(scene, cam, light, cfg, ShadowConfig(), d,
                                  target, cuda_device, None, graphed=False)
        for x, y in zip(frame_prep.tables(got), frame_prep.tables(want)):
            assert torch.equal(_bits(x), _bits(y))
    # Op by op (frame 0), warm-up and capture (frame 1), the three
    # references; the replay (frame 2) runs the captured launches.
    assert setup_cuda.LAUNCHES["setup_tables"] == 6
    frame_prep.PREP_GRAPH.clear()
