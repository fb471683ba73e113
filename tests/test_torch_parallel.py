"""Port parity, multi-device rendering (``parallel/sharding.py``): the
checks of tests/test_parallel.py at its sizes, on CPU ranks of a gloo
process group (``torch.multiprocessing.spawn``, a file store under
``tmp_path``), and ``BandedCamera`` against the JAX one.

One group is spawned per rank count and runs every check of that count;
rank 0 writes what it saw, and the test holds it against the unsharded
render and against the JAX package. Every check runs the reference
backend and the kernels (their plain twins here: the JAX package marks
its kernel cases slow only for interpret mode).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.parallel import sharding
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting

BACKENDS = ("reference", "kernels")
TARGET = (0.0, 0.0, -1.0)
DISPS = [0.0, 0.05, 0.1, 0.2]
THETAS = [2.3, 2.45, 2.6, 2.75]


def _flagship(w, h):
    cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
    cfg = RenderConfig(width=w, height=h, msaa=1, shadow_map_size=64)
    return audio_app.build_scene(device="cpu"), cam, Lighting.default(), cfg


def _sphere(device="cpu"):
    """tests/test_parallel.py's sphere: big enough on screen that bands see
    distinct slices (1,920 triangles)."""
    from metalrenderer_tpu_torch.scene.materials import BLINN_PHONG, Material
    from metalrenderer_tpu_torch.scene.mesh import uv_sphere
    from metalrenderer_tpu_torch.scene.scene import Instance, Scene
    inst = Instance(mesh=uv_sphere(stacks=25, slices=40, radius=1.4,
                                   device=device),
                    model_matrix=torch.eye(4, device=device),
                    material=Material(kind=BLINN_PHONG, color=torch.tensor(
                        [0.8, 0.3, 0.2], device=device)))
    cam = OrbitCamera(radius=2.2, theta=2.5, phi=1.2, aspect=2.0)
    cfg = RenderConfig(width=128, height=64, msaa=1, shadow_map_size=64)
    return Scene(instances=(inst,)), cam, Lighting.default(), cfg


def _jax_sphere():
    """The same sphere and camera in the JAX package."""
    import jax.numpy as jnp
    from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
    from metalrenderer_tpu.scene.materials import BLINN_PHONG, Material
    from metalrenderer_tpu.scene.mesh import uv_sphere
    from metalrenderer_tpu.scene.scene import Instance, Scene
    inst = Instance(mesh=uv_sphere(stacks=25, slices=40, radius=1.4),
                    model_matrix=jnp.eye(4, dtype=jnp.float32),
                    material=Material(kind=BLINN_PHONG,
                                      color=jnp.asarray([0.8, 0.3, 0.2])))
    return (Scene(instances=(inst,)),
            JCamera(radius=2.2, theta=2.5, phi=1.2, aspect=2.0))


def _checks_4(mesh):
    """The frame-batch DP at 64x64 and the tile-sharded frame at 128x64."""
    out = {}
    for backend in BACKENDS:
        scene, cam, lighting, cfg = _flagship(64, 64)
        out[f"batch_{backend}"] = sharding.render_frame_batch(
            scene, cam, lighting, DISPS, THETAS, mesh, cfg, ShadowConfig(),
            shadow_target=TARGET, backend=backend)
        scene, cam, lighting, cfg = _flagship(128, 64)
        out[f"tile_{backend}"] = sharding.render_tile_sharded(
            scene, cam, lighting, mesh, cfg, ShadowConfig(),
            shadow_target=TARGET, backend=backend, with_stats=True)
    return out


def _checks_8(mesh):
    """Per-band pruning on the sphere."""
    scene, cam, lighting, cfg = _sphere()
    return {backend: sharding.render_tile_sharded(
        scene, cam, lighting, mesh, cfg, ShadowConfig(), backend=backend,
        with_stats=True) for backend in BACKENDS}


def _checks_2(mesh):
    """A capacity overflow: slack 0.2, so each band holds 192 of the
    sphere's 1,920 triangles. With stats it is counted; without, it
    warns."""
    scene, cam, lighting, cfg = _sphere()
    out = {}
    for backend in BACKENDS:
        _, out[backend] = sharding.render_tile_sharded(
            scene, cam, lighting, mesh, cfg, ShadowConfig(), backend=backend,
            band_slack=0.2, with_stats=True)
    with pytest.warns(RuntimeWarning, match="dropped"):
        sharding.render_tile_sharded(scene, cam, lighting, mesh, cfg,
                                     ShadowConfig(), backend="reference",
                                     band_slack=0.2)
    out["warned"] = True
    return out


CHECKS = {4: _checks_4, 8: _checks_8, 2: _checks_2}


def _rank_main(rank, world, store, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = sharding.make_mesh(world, device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank)
        out = CHECKS[world](mesh)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path):
    out_path = tmp_path / f"out{world}.pt"
    mp.spawn(_rank_main, args=(world, str(tmp_path / f"store{world}"),
                               str(out_path)), nprocs=world, join=True)
    return torch.load(out_path)


@pytest.mark.parametrize("backend", BACKENDS)
def test_four_ranks(backend, four_rank_results):
    out = four_rank_results
    # The frame-batch DP: every frame equals the unsharded render.
    scene, cam, lighting, cfg = _flagship(64, 64)
    fbs = out[f"batch_{backend}"]
    assert fbs.shape == (4, 64, 64, 4)
    for i, (d, t) in enumerate(zip(DISPS, THETAS)):
        fb, _ = pipeline.render_frame(
            scene, OrbitCamera(radius=5.0, theta=t, phi=1.2, aspect=1.0),
            lighting, cfg, ShadowConfig(), d, TARGET, backend, "cpu")
        assert torch.equal(fbs[i], fb), i
    # The tile-sharded frame: within 1e-4 of the unsharded frame.
    scene, cam, lighting, cfg = _flagship(128, 64)
    fb, stats = out[f"tile_{backend}"]
    ref, _ = pipeline.render_frame(scene, cam, lighting, cfg, ShadowConfig(),
                                   0.0, TARGET, backend, "cpu")
    assert fb.shape == (64, 128, 4)
    assert float((fb - ref).abs().max()) <= 1e-4
    assert stats["band_triangles"].shape == (4,)
    assert int(stats["band_dropped"].sum()) == 0


@pytest.fixture(scope="module")
def four_rank_results(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def eight_rank_results(tmp_path_factory):
    return _spawn(8, tmp_path_factory.mktemp("ranks8"))


@pytest.fixture(scope="module")
def two_rank_results(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("ranks2"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sharded_prunes_per_rank_work(backend, eight_rank_results):
    """Each band's in-band count is a fraction of T, the static capacity is
    ~2T/n, nothing overflows, the counts equal the JAX ``prune_to_band``'s,
    and the pruned sharded frame equals the unsharded one within 1e-4."""
    from metalrenderer_tpu.parallel import sharding as j_sharding
    from metalrenderer_tpu.scene.scene import bake as j_bake

    fb, stats = eight_rank_results[backend]
    scene, cam, lighting, cfg = _sphere()
    t = scene.num_triangles
    assert t > 1500
    counts = stats["band_triangles"]
    assert counts.shape == (8,)
    assert stats["band_capacity"] <= -(-2 * t // 8)
    assert int(stats["band_dropped"].max()) == 0
    assert int(counts.max()) < 0.55 * t
    assert int(counts.sum()) >= 0.5 * t
    js, jcam = _jax_sphere()
    geom = j_bake(js, 0.0)
    want = [int(j_sharding.prune_to_band(
        geom, jcam.view_matrix(), jcam.projection_matrix(), 128, 64, b, 8,
        stats["band_capacity"])[1]) for b in range(8)]
    assert counts.tolist() == want
    ref, _ = pipeline.render_frame(scene, cam, lighting, cfg, backend=backend,
                                   device="cpu")
    assert float((fb - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sharded_overflow_is_reported_not_silent(backend,
                                                      two_rank_results):
    stats = two_rank_results[backend]
    assert stats["band_capacity"] == 192
    assert int(stats["band_dropped"].max()) > 0
    assert two_rank_results["warned"]


@pytest.fixture(scope="module")
def jax_bands():
    """The JAX package's 4 bands of the 128x64 flagship: per band its
    reference-backend frame (``BandedCamera``, ``prune_to_band`` and
    ``render_frame(main_geom=)``, as its ``render_tile_sharded`` renders a
    band) and in-band count."""
    from metalrenderer_tpu.config import RenderConfig as JConfig
    from metalrenderer_tpu.config import ShadowConfig as JShadowConfig
    from metalrenderer_tpu.engine import audio_app as j_app
    from metalrenderer_tpu.parallel import sharding as j_sharding
    from metalrenderer_tpu.passes.pipeline import render_frame as j_render
    from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
    from metalrenderer_tpu.scene.lights import Lighting as JLighting
    from metalrenderer_tpu.scene.scene import bake as j_bake
    n, w, h = 4, 128, 64
    scene = j_app.build_scene()
    cam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
    cfg = JConfig(width=w, height=h // n, msaa=1, shadow_map_size=64)
    cap = j_sharding.band_capacity(scene.num_triangles, n)
    out = []
    for b in range(n):
        pruned, n_in, _ = j_sharding.prune_to_band(
            j_bake(scene, 0.0), cam.view_matrix(), cam.projection_matrix(),
            w, h, b, h // n, cap)
        fb, _ = j_render(scene, j_sharding.BandedCamera(
            base=cam, band=b, n_bands=n), JLighting.default(), cfg,
            JShadowConfig(), 0.0, TARGET, "reference", main_geom=pruned)
        out.append((np.asarray(fb), int(n_in)))
    return out


# The largest channel difference of a band from the JAX package's band,
# measured: 1.49e-5 (the prep's rounding, ROADMAP C9).
@pytest.mark.parametrize("backend", BACKENDS)
def test_band_matches_jax(backend, jax_bands):
    """Each band of the 128x64 flagship in 4 bands, rendered by the port's
    ``render_band`` (the ``main_geom=`` path of ``prepare_frame``), against
    the JAX package's band on the same inputs: the same in-band count, no
    drop, and every channel within 2e-5."""
    scene, cam, lighting, cfg = _flagship(128, 64)
    for b, (want, n_want) in enumerate(jax_bands):
        fb, n_in, dropped = sharding.render_band(
            scene, cam, lighting, b, 4, cfg, shadow_target=TARGET,
            backend=backend, device="cpu")
        assert fb.shape == want.shape and torch.isfinite(fb).all()
        assert (int(n_in), int(dropped)) == (n_want, 0), b
        assert float(np.abs(fb.numpy() - want).max()) <= 2e-5, b


@pytest.mark.parametrize("n", [2, 4, 8])
def test_banded_camera_matches_jax(n):
    """The band projection, bit-equal to the JAX ``BandedCamera``'s for
    every band, over the orbit and the pose camera."""
    from metalrenderer_tpu.parallel.sharding import BandedCamera as JBanded
    from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
    from metalrenderer_tpu_torch import convert
    jcam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=2.0)
    cams = [(jcam, convert.camera_from_jax(jcam)),
            (jcam.pose(), convert.pose_camera_from_jax(jcam.pose()))]
    for jc, pc in cams:
        for b in range(n):
            want = np.asarray(JBanded(base=jc, band=b, n_bands=n)
                              .projection_matrix())
            got = sharding.BandedCamera(base=pc, band=b,
                                        n_bands=n).projection_matrix()
            assert np.array_equal(got.numpy(), want), (n, b)
            bc = sharding.BandedCamera(base=pc, band=b, n_bands=n)
            assert torch.equal(bc.view_matrix(), pc.view_matrix())


def test_single_rank_mesh_needs_no_group():
    """Without a process group the mesh is this process alone: the batch
    and the sharded frame are the unsharded renders, bit for bit."""
    mesh = sharding.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    with pytest.raises(ValueError, match="num_devices"):
        sharding.make_mesh(2, device="cpu")
    scene, cam, lighting, cfg = _flagship(64, 32)
    fb = sharding.render_tile_sharded(scene, cam, lighting, mesh, cfg,
                                      ShadowConfig(), shadow_target=TARGET)
    ref, _ = pipeline.render_frame(scene, cam, lighting, cfg, ShadowConfig(),
                                   0.0, TARGET, device="cpu")
    assert torch.equal(fb, ref)
    fbs = sharding.render_frame_batch(scene, cam, lighting, DISPS[:2],
                                      THETAS[:2], mesh, cfg, ShadowConfig(),
                                      shadow_target=TARGET)
    rgba, _ = pipeline.render_batch(scene, cam, lighting, DISPS[:2],
                                    THETAS[:2], config=cfg,
                                    shadow_target=TARGET, device="cpu")
    assert torch.equal(fbs, rgba)
    with pytest.raises(ValueError, match="divisible"):
        sharding.render_band(scene, cam, lighting, 0, 3, cfg, device="cpu")
