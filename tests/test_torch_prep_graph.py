"""The prep graph (``passes.prep.PREP_GRAPH``): on the card the frame's
prep is a CUDA graph captured once per shape and replayed.

On the CPU: the shape key (equal for frames that differ in displacement,
light color or camera; different when a triangle count, the shadow pass, a
config field the prep reads or ``main_geom`` changes), that the CPU and the
reference backend never capture, the cache's bound and when it captures,
and the copies that keep a graph's outputs apart from the next replay
(``prepare_frame``'s tables, the stats ``render_frame`` hands back, a
batch's slots), on CPU preps marked static whose tables a fake replay
rewrites in place.

On the card (``-m cuda``): graphed preps bit-equal to the op-by-op prep,
for one frame and for an 8-frame fused batch with eight displacements and
light colors, and a second scene shape capturing a second graph.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from metalrenderer_tpu_torch.config import RenderConfig, ShadowConfig
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.passes import pipeline
from metalrenderer_tpu_torch.passes import prep as frame_prep
from metalrenderer_tpu_torch.raster.binning import TileBins
from metalrenderer_tpu_torch.scene import mesh
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
from metalrenderer_tpu_torch.scene.scene import Instance, Scene, bake
from metalrenderer_tpu_torch.utils import cuda_graphs

W, H = 128, 64
CFG = RenderConfig(width=W, height=H, msaa=4, shadow_map_size=64)
CAM = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=W / H)
TARGET = (0.0, 0.0, -1.0)
DISPS = [0.0, 0.01, 0.02, 0.03, 0.05, 0.08, 0.35, 5.0]
THETAS = [2.5, 2.55, 2.6, 2.45, 2.4, 2.8, 2.2, 2.5]
COLORS = [(1.0, 1.0, 1.0), (1.0, 0.2, 0.1), (0.2, 1.0, 0.3),
          (0.1, 0.3, 1.0), (0.9, 0.9, 0.1), (0.5, 0.5, 0.5),
          (1.0, 0.6, 0.0), (0.3, 0.0, 0.8)]


def _key(scene, config=CFG, main_geom=None, device="cpu"):
    return frame_prep.prep_graph_key(scene, config, device, main_geom)


def _lighting(color):
    return Lighting(light=PointLight(color=color), ambient_intensity=0.1,
                    shininess=32.0)


def test_key_is_shared_by_frames_of_one_shape():
    """Light color (the light cube's material), displacement and camera are
    the graph's inputs, not its shape; so are the config fields that reach
    the prep only through the uniforms."""
    keys = {_key(audio_app.build_scene(light_color=c, device="cpu"))
            for c in COLORS}
    keys.add(_key(audio_app.build_scene(device="cpu"),
                  CFG.replace(clear_color=(0.0, 0.0, 0.0, 1.0),
                              shadow_bias=0.01, shadow_factor=0.25)))
    assert len(keys) == 1


def test_key_changes_with_what_fixes_the_prep():
    scene = audio_app.build_scene(device="cpu")
    base = _key(scene)
    cube, light_cube, plane = scene.instances
    sphere = Instance(mesh=mesh.uv_sphere(8, 16), model_matrix=torch.eye(4),
                      material=cube.material, cast_shadow=True,
                      use_displacement=True)
    no_caster = dataclasses.replace(cube, cast_shadow=False)
    geom = bake(scene)
    changed = [
        _key(Scene(instances=(sphere, light_cube, plane))),      # T
        _key(Scene(instances=(no_caster, light_cube, plane))),   # shadow
        _key(scene, CFG.replace(width=W + 8)),
        _key(scene, CFG.replace(span_cap=4)),
        _key(scene, CFG.replace(shadow_map_size=128)),
        _key(scene, CFG.replace(xyclip_capacity=0)),
        _key(scene, main_geom=geom),
        _key(scene, device="cuda:1"),
    ]
    assert not frame_prep.wants_shadow(Scene(
        instances=(no_caster, light_cube, plane)))
    assert base not in changed
    assert len(set(changed)) == len(changed)


def test_cpu_and_reference_preps_never_capture():
    before = (frame_prep.PREP_GRAPH.captures, frame_prep.PREP_GRAPH.replays)
    scene = audio_app.build_scene(device="cpu")
    for backend in ("kernels", "reference"):
        prep = pipeline.prepare_frame(scene, CAM, Lighting.default(), CFG,
                                      displacement=0.05,
                                      shadow_target=TARGET, backend=backend,
                                      device="cpu")
        if backend == "reference":
            assert isinstance(prep, pipeline.ReferencePrep)
        else:
            assert not prep.static
    pipeline.render_frame(scene, CAM, Lighting.default(), CFG,
                          device="cpu")
    assert (frame_prep.PREP_GRAPH.captures,
            frame_prep.PREP_GRAPH.replays) == before


def test_cache_frees_its_least_recently_used_graph_at_its_bound():
    made = []

    def make(name):
        def f():
            made.append(name)
            return name
        return f
    graphs = cuda_graphs.GraphCache(size=2)
    assert graphs.add("a", make("a")) == "a"
    graphs.add("b", make("b"))
    assert graphs.get("a") == "a"          # a is now the most recent
    graphs.add("c", make("c"))
    assert list(graphs.graphs) == ["a", "c"]
    assert graphs.get("b") is None
    graphs.add("d", make("d"))
    assert list(graphs.graphs) == ["c", "d"]
    assert made == ["a", "b", "c", "d"] and graphs.captures == 4
    assert graphs.replays == 0
    # A freed shape never captures again.
    assert not any(graphs.due(k) for k in "ab" for _ in range(3))
    graphs.clear()
    assert not graphs.graphs and not graphs.seen
    assert [graphs.due("a") for _ in range(3)] == [False, True, False]


def test_shape_captures_at_its_second_frame():
    """A shape's first frame runs op by op; its second captures; shapes
    that take turns beyond the cache's size capture once each; the cache
    forgets the oldest shapes beyond ``remembered``."""
    graphs = cuda_graphs.GraphCache(size=2, remembered=3)

    def frame(key):
        if graphs.get(key) is not None:
            graphs.replays += 1
            return "replay"
        if graphs.due(key):
            graphs.add(key, lambda: key)
            return "capture"
        return "op by op"
    assert [frame(k) for k in "aab"] == ["op by op", "capture", "op by op"]
    assert [frame(k) for k in "aab"] == ["replay", "replay", "capture"]
    # Three shapes in turn, beyond the size of 2: c's capture frees a,
    # which runs op by op from then on.
    rounds = [[frame(k) for k in "abc"] for _ in range(3)]
    assert rounds == [["replay", "replay", "op by op"],
                      ["replay", "replay", "capture"],
                      ["op by op", "replay", "replay"]]
    assert graphs.captures == 3 and list(graphs.graphs) == ["b", "c"]
    # Beyond ``remembered`` the oldest shape is forgotten, and a shape
    # never seen is counted afresh.
    for k in "defg":
        assert frame(k) == "op by op"
    assert len(graphs.seen) == 3 and "a" not in graphs.seen
    assert [frame("a") for _ in range(2)] == ["op by op", "capture"]


def _cpu_prep(d=0.05, theta=2.5, color=(1.0, 1.0, 1.0)):
    return pipeline.prepare_frame(
        audio_app.build_scene(light_color=color, device="cpu"),
        dataclasses.replace(CAM, theta=theta), _lighting(color), CFG,
        displacement=d, shadow_target=TARGET, device="cpu")


def _assert_same_tables(a, b):
    ta, tb = frame_prep.tables(a), frame_prep.tables(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x.reshape(-1).view(torch.int32),
                           y.reshape(-1).view(torch.int32))


def _stack(preps):
    """A batch stacked as ``raster_cuda.stack_bins`` and ``torch.stack``
    stack it, the slot copies' reference."""
    from metalrenderer_tpu_torch.raster import raster_cuda
    return frame_prep.FramePrep(
        shadow_bins=raster_cuda.stack_bins([p.shadow_bins for p in preps]),
        main_bins=raster_cuda.stack_bins([p.main_bins for p in preps]),
        uniforms=torch.stack([p.uniforms for p in preps]),
        light_dir=None, textures=(), fused=preps[0].fused,
        stats=pipeline._stack_stats([p.stats for p in preps]))


def _replays(preps):
    """A stand-in for a prep graph on the CPU: one prep marked static,
    whose tables each "replay" rewrites in place with the next of
    ``preps``."""
    static = frame_prep.with_tables(
        preps[0], [t.clone() for t in frame_prep.tables(preps[0])])
    static = dataclasses.replace(static, static=True)
    for p in preps:
        for dst, src in zip(frame_prep.tables(static), frame_prep.tables(p)):
            dst.copy_(src)
        yield static


def _replayed_by_prepare(monkeypatch, preps):
    """``prep.prepare`` made to return ``_replays(preps)`` in turn, as the
    card's graph does, for ``prepare_frame`` and ``render_frame``."""
    replays = _replays(preps)
    monkeypatch.setattr(frame_prep, "prepare", lambda *a, **k: next(replays))
    return replays


def _frame(d, theta, color):
    return (audio_app.build_scene(light_color=color, device="cpu"),
            dataclasses.replace(CAM, theta=theta), _lighting(color), CFG)


def test_prepare_frame_copies_a_static_prep(monkeypatch):
    """``prepare_frame`` hands a caller a copy of a graph's outputs, which
    the next replay leaves alone; the render functions, under
    ``_handed_over``, take the outputs themselves."""
    frames = list(zip(DISPS[:3], THETAS[:3], COLORS[:3]))
    want = [_cpu_prep(*f) for f in frames]
    _replayed_by_prepare(monkeypatch, want)
    kept = pipeline.prepare_frame(*_frame(*frames[0]), device="cpu")
    assert not kept.static
    _assert_same_tables(kept, want[0])
    with pipeline._handed_over():
        second = pipeline.prepare_frame(*_frame(*frames[1]), device="cpu")
    assert second.static
    _assert_same_tables(second, want[1])
    _assert_same_tables(kept, want[0])
    for x, y in zip(frame_prep.tables(kept), frame_prep.tables(second)):
        assert x.data_ptr() != y.data_ptr()
    assert not pipeline._HAND_OVER.get()
    third = pipeline.prepare_frame(*_frame(*frames[2]), device="cpu")
    assert not third.static
    _assert_same_tables(second, want[2])     # rewritten by the replay
    _assert_same_tables(kept, want[0])


def test_render_frame_stats_outlive_the_next_replay(monkeypatch):
    frames = list(zip(DISPS[6:8], THETAS[6:8], COLORS[6:8]))
    preps = [_cpu_prep(*f) for f in frames]
    replays = _replayed_by_prepare(monkeypatch, preps)
    _, stats = pipeline.render_frame(*_frame(*frames[0]), device="cpu")
    want = {k: v.clone() for k, v in stats.items()}
    next(replays)
    assert set(stats) == set(want)
    for k in want:
        assert torch.equal(stats[k], want[k]), k
    # The replayed frame (displacement 5.0 near-clips) differs in its stats.
    _, later = pipeline.render_prepared(preps[1], CFG)
    assert any(not torch.equal(stats[k], later[k]) for k in
               ("culled_triangles", "max_screen_coord"))


def test_batch_slots_keep_every_replay():
    """``stack_preps`` copies each graphed frame into its slot before the
    next replay: the stacked tables equal the frames' own preps stacked."""
    frames = list(zip(DISPS, THETAS, COLORS))
    preps = [_cpu_prep(*f) for f in frames]
    batch = pipeline.stack_preps(_replays(preps), len(frames))
    want = _stack(preps)
    for name in ("shadow_bins", "main_bins"):
        a, b = getattr(batch, name), getattr(want, name)
        for k in TileBins.TABLES:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.shape == y.shape and torch.equal(x, y), (name, k)
        assert (a.tile_w, a.tile_h, a.ntx, a.nty) == (
            b.tile_w, b.tile_h, b.ntx, b.nty)
    assert torch.equal(batch.uniforms, want.uniforms)
    assert list(batch.stats) == list(want.stats)
    for k in want.stats:
        assert torch.equal(batch.stats[k], want.stats[k]), k
    with pytest.raises(ValueError, match="preps for a batch"):
        pipeline.stack_preps(_replays(preps[:2]), 3)


class _HostTraffic(TorchDispatchMode):
    """Records the ops a CUDA graph capture refuses, on a CPU run: host
    data made into a tensor (an upload on the card), a read of a value on
    the host (a sync), and ops whose output size needs one."""

    SYNCS = ("lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
             "nonzero", "masked_select", "repeat_interleave", "unique",
             "_unique", "_unique2", "unique_consecutive")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masks = name.startswith("index") and len(args) > 1 and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in (args[1] if isinstance(args[1], (list, tuple)) else ()))
        if name in self.SYNCS or masks:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


class _OffDevice(TorchDispatchMode):
    """Records the ops of a run on the meta device that take a tensor from
    elsewhere: a tensor the host made, which the card would need uploaded."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def tensors(x):
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                for y in x:
                    yield from tensors(y)
        if any(t.device.type != "meta" for t in tensors(
                [args, list((kwargs or {}).values())])):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def _case(name):
    """(scene, camera, lighting, config, shadow_target, main_geom) on the
    CPU: the flagship, a scene with no shadow pass, the guard-band clip
    off, config 4's textured split-path scene and a band's pruned soup."""
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.parallel import sharding
    scene = audio_app.build_scene(device="cpu")
    if name == "flagship":
        return scene, CAM, Lighting.default(), CFG, TARGET, None
    if name == "no_shadow":
        return (*configs.config2_multi_mesh(n_objects=4, width=W, height=H,
                                            device="cpu"), TARGET, None)
    if name == "no_xyclip":
        return (scene, CAM, Lighting.default(),
                CFG.replace(xyclip_capacity=0), TARGET, None)
    if name == "config4":
        return (*configs.config4_shadow_normal_map(W, H, device="cpu"),
                (0.0, 0.0, 0.0), None)
    band_h = H // 2
    pruned, _, _ = sharding.prune_to_band(
        bake(scene, 0.05), CAM.view_matrix(),
        CAM.projection_matrix(), W, H, 1, band_h,
        sharding.band_capacity(scene.num_triangles, 2))
    return (scene, sharding.BandedCamera(base=CAM, band=1, n_bands=2),
            Lighting.default(), CFG.replace(height=band_h), TARGET, pruned)


CASES = ["flagship", "no_shadow", "no_xyclip", "config4", "band"]


@pytest.mark.parametrize("name", CASES)
def test_graph_body_is_the_prep_op_by_op(name):
    """What a prep graph captures (``graph_body`` on the static inputs:
    the geometry's tensors, the one upload) computes the op-by-op prep's
    tables bit for bit on the CPU, makes no op that syncs or brings host
    data up, and runs on the meta device taking no host tensor."""
    scene, cam, lighting, cfg, target, main_geom = _case(name)
    shadow, m, vp, uniforms = frame_prep.host_side(
        scene, cam, lighting, cfg, ShadowConfig(), target)
    upload = frame_prep.frame_upload(0.05, vp, m, uniforms)
    n_tris = torch.tensor((scene if main_geom is None else
                           main_geom).num_triangles, dtype=torch.int32)

    def inputs(device):
        geometry = [t.to(device) for t in
                    frame_prep.geometry_tensors(scene, main_geom)]
        sc, mg = frame_prep.with_geometry(scene, main_geom, geometry)
        return sc, mg, upload.to(device), shadow, cfg, n_tris.to(device)
    args = inputs("cpu")
    with _HostTraffic() as traffic:
        got = frame_prep.graph_body(*args)
    assert traffic.found == []
    assert got.static and (got.shadow_bins is None) == (not shadow)
    want = frame_prep.prepare(scene, cam, lighting, cfg, ShadowConfig(), 0.05,
                              target, torch.device("cpu"), main_geom,
                              graphed=False)
    _assert_same_tables(got, want)
    assert list(got.stats) == list(want.stats)
    args = inputs("meta")
    with _OffDevice() as off:
        meta = frame_prep.graph_body(*args)
    assert off.found == []
    assert [t.shape for t in frame_prep.tables(meta)] == [
        t.shape for t in frame_prep.tables(want)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the prep graph is a CUDA graph)")
    return torch.device("cuda")


def _eager(scene, cam, lighting, d, device):
    """The op-by-op prep on the card, the graph's reference."""
    return frame_prep.prepare(scene, cam, lighting, CFG, ShadowConfig(), d,
                              TARGET, device, None, graphed=False)


@pytest.mark.cuda
def test_graphed_prep_is_bit_equal_on_card(cuda_device):
    """From an empty cache: the first frame runs op by op, the second
    captures, the third replays; each frame's prep, handed over or
    copied, and its render equal the op-by-op prep's bit for bit."""
    scene = audio_app.build_scene(device=cuda_device)
    frame_prep.PREP_GRAPH.clear()
    captures = frame_prep.PREP_GRAPH.captures
    replays = frame_prep.PREP_GRAPH.replays
    for f, (d, t) in enumerate(zip(DISPS[:3], THETAS[:3])):
        cam = dataclasses.replace(CAM, theta=t)
        with pipeline._handed_over():
            prep = pipeline.prepare_frame(scene, cam, Lighting.default(),
                                          CFG, displacement=d,
                                          shadow_target=TARGET,
                                          device=cuda_device)
        assert prep.static == (f > 0)
        eager = _eager(scene, cam, Lighting.default(), d, cuda_device)
        _assert_same_tables(prep, eager)
        kept = pipeline.prepare_frame(scene, cam, Lighting.default(), CFG,
                                      displacement=d, shadow_target=TARGET,
                                      device=cuda_device)
        assert not kept.static
        _assert_same_tables(kept, eager)
        fb, st = pipeline.render_frame(scene, cam, Lighting.default(), CFG,
                                       displacement=d, shadow_target=TARGET,
                                       device=cuda_device)
        fb_e, st_e = pipeline.render_prepared(eager, CFG)
        assert torch.equal(fb, fb_e)
        for k in st_e:
            assert torch.equal(st[k], st_e[k]), k
    assert frame_prep.PREP_GRAPH.captures == captures + 1
    assert frame_prep.PREP_GRAPH.replays == replays + 7


@pytest.mark.cuda
def test_graphed_batch_is_bit_equal_on_card(cuda_device):
    """Eight frames with eight displacements and light colors through the
    fused batch (from an empty cache: one frame op by op, one capture, six
    replays), then through replays alone: every frame and the stacked
    tables equal the op-by-op prep's, so no replay overwrote a frame
    before it was stacked."""
    scenes = [audio_app.build_scene(light_color=c, device=cuda_device)
              for c in COLORS]
    cams = [dataclasses.replace(CAM, theta=t) for t in THETAS]
    frame_prep.PREP_GRAPH.clear()
    rgba, stats = pipeline.render_frame_batch_fused(
        scenes[0], CAM, _lighting(COLORS[0]), CFG, ShadowConfig(), DISPS,
        THETAS, shadow_target=TARGET, scene_fn=lambda f: scenes[f],
        lighting_fn=lambda f: _lighting(COLORS[f]),
        frame_params=list(range(8)), device=cuda_device)
    eager = [_eager(s, c, _lighting(col), d, cuda_device)
             for s, c, col, d in zip(scenes, cams, COLORS, DISPS)]

    def replays():
        for s, c, col, d in zip(scenes, cams, COLORS, DISPS):
            with pipeline._handed_over():
                prep = pipeline.prepare_frame(
                    s, c, _lighting(col), CFG, displacement=d,
                    shadow_target=TARGET, device=cuda_device)
            assert prep.static
            yield prep
    batch = pipeline.stack_preps(replays(), 8)
    want = _stack(eager)
    for name in ("shadow_bins", "main_bins"):
        for k in TileBins.TABLES:
            x = getattr(getattr(batch, name), k)
            y = getattr(getattr(want, name), k)
            assert (x is None) == (y is None), (name, k)
            if x is not None:
                assert torch.equal(x.reshape(-1).view(torch.int32),
                                   y.reshape(-1).view(torch.int32)), (name, k)
    assert torch.equal(batch.uniforms, want.uniforms)
    for f, prep in enumerate(eager):
        fb, st = pipeline.render_prepared(prep, CFG)
        assert torch.equal(rgba[f], fb), f
        for k in st:
            assert torch.equal(stats[k][f], st[k]), (f, k)


@pytest.mark.cuda
def test_second_shape_captures_a_second_graph(cuda_device):
    scene = audio_app.build_scene(device=cuda_device)
    cube, light_cube, plane = scene.instances
    sphere = dataclasses.replace(cube, mesh=mesh.uv_sphere(8, 16).to(
        cuda_device))
    other = Scene(instances=(sphere, light_cube, plane))
    frame_prep.PREP_GRAPH.clear()
    captures = frame_prep.PREP_GRAPH.captures
    for s in (scene, other, scene, other):  # each shape's second captures
        pipeline.render_frame(s, CAM, Lighting.default(), CFG,
                              device=cuda_device)
    assert frame_prep.PREP_GRAPH.captures == captures + 2
    replays = frame_prep.PREP_GRAPH.replays
    for s in (scene, other, scene):
        pipeline.render_frame(s, CAM, Lighting.default(), CFG,
                              displacement=0.02, device=cuda_device)
    assert frame_prep.PREP_GRAPH.captures == captures + 2
    assert frame_prep.PREP_GRAPH.replays == replays + 3
    keys = {_key(s, device=pipeline.resolve_device(cuda_device))
            for s in (scene, other)}
    assert len(keys) == 2 and set(frame_prep.PREP_GRAPH.graphs) == {
        _key(s, device=torch.device("cuda", torch.cuda.current_device()))
        for s in (scene, other)}
