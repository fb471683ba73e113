"""Two-pass render pipeline: shadow pass + main pass.

Torch counterpart of ``metalrenderer_tpu.passes.pipeline``. The rasterizer
backend is pluggable, as there:
  * ``"kernels"`` (the default; the JAX package's ``"pallas"``): the
    tile-binned CUDA kernels below, their plain twins on the CPU;
  * ``"reference"`` (the JAX package's default): the brute-force oracle of
    ``raster/reference_cpu.py`` on the same triangle setup, no binning and
    no kernel: visibility with the kernels' anchored plane arithmetic, an
    array-of-structs G-buffer, and ``shade.shade_channels`` with the plain
    gather samplers (``tiled_sampler=False``), then the MSAA resolve.
Frame anatomy of the kernels backend (MtlEngine::draw,
mtl_engine.mm:767-770):
  1. shadow pass: depth-only render of the shadow casters from the light
     (renderShadowPass, :772-792) -> kernel K1 ``raster_depth``;
  2. main pass, one of three branches:
     * fused (untextured scene, point light, ``fused_shade``, per-pixel
       shading on 8x128 tiles): raster + Blinn-Phong/emissive shading +
       shadow test + MSAA coverage resolve in one launch -> kernel K2
       ``render_fused``;
     * split (textures, normal maps, a directional light, or
       ``fused_shade=False``): per-pixel G-buffer raster -> kernel K3
       ``raster_gbuffer``, then ``channels_from_gout_px`` and
       ``shade.shade_channels``, whose shadow test runs kernel K7 and whose
       texture and normal-map lookups run kernel K9;
     * per sample (``shading_per_pixel=False``, or main-pass tiles other
       than 8x128): per-sample G-buffer raster -> kernel K3s
       ``raster_gbuffer_samples``, ``channels_from_gout`` and the same
       shading on [S, H, W] planes: once per pixel at the first covered
       sample, or supersampled with a box resolve.
Everything between the kernels (vertex stage, clipping, triangle setup,
binning, the split path's elementwise shading) is ordinary tensor code on
the render device, but for the main pass's front end (projection, clipping,
setup and its tables), which on the card is one more kernel
(``raster/setup_cuda``). On the card the frame's prep (``prepare_frame``:
vertex stage to binning) runs as one CUDA graph per scene shape, captured
at its second frame and replayed at every later one (``PREP_GRAPH``).

The frame-batch API (``render_batch`` and the ``render_frame_batch_*``
functions, as in the JAX package) runs the same frames through the batch
kernels: K4 for the shadow pass, K6 for the fused main pass, or K5 with
the split shading on [F, H, W] planes (K8 for the shadow test, K9).
The per-sample branch has no batch kernel (nor has the JAX package):
``render_batch`` renders such frames one by one.

Entry points render on the GPU (``device="cuda"``) unless the caller asks
for the CPU; on a CUDA device the kernels run, on the CPU their plain twins.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools

import torch

from ..config import RenderConfig, ShadowConfig
from ..math import transforms
from ..raster import raster_cuda, reference_cpu, setup_cuda, shade
from ..raster.binning import bin_triangles, build_tri_fields
from ..raster.geometry import clip_near, setup_triangles
from ..raster.setup_cuda import PassGeometry, prepare_main_pass
from ..scene import lights as lights_mod
from ..scene.materials import BLINN_PHONG_SHADOW
from ..scene.mesh import Mesh
from ..scene.scene import PackedGeometry, Scene, bake
from ..utils.profiling import annotate


# The shadow pass bins with the JAX kernels' default span cap, whatever
# config.span_cap says: every JAX shadow pass (rasterize_tiles,
# rasterize_depth_batch) leaves span_cap at its default of 8.
SHADOW_SPAN_CAP = 8


def resolve_device(device) -> torch.device:
    """The render device; a CUDA device without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but "
                           "torch.cuda.is_available() is false")
    return device


def _wants_shadow(scene: Scene):
    """Does any instance cast AND any instance receive shadows?"""
    casts = any(i.cast_shadow for i in scene.instances)
    receives = any(
        i.material.kind == BLINN_PHONG_SHADOW for i in scene.instances
    )
    return casts and receives


def _fused_uniforms(m, camera, light_anchor, light, lighting, config):
    """Pack the shading uniforms (raster_cuda.FU_* layout: the fused
    kernel's, read by the split path's shading too), f32[33] on the CPU."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    return torch.cat([
        f32(m), f32(camera.position), f32(light_anchor), f32(light.color),
        f32(lighting.ambient_intensity), f32(lighting.shininess),
        f32(config.clear_color), f32(config.shadow_bias),
        f32(config.shadow_factor),
    ])


def _raster_gbuffer_reference(setup, pg: PassGeometry, config: RenderConfig):
    """The reference backend's main pass: brute-force visibility anchored
    at the main-pass tiles (so z-fighting samples resolve as the kernels
    resolve them) and the per-sample G-buffer."""
    samples = tuple(config.sample_positions)
    depth, winner = reference_cpu.rasterize_brute_force(
        setup, config.width, config.height, samples,
        anchor=(config.tile_w, config.tile_h))
    return reference_cpu.interpolate_gbuffer(
        setup, winner, config.width, config.height, samples, pg.vattrs,
        pg.mat_kind, pg.mat_color, pg.tex_id, depth,
        normal_map_id=pg.normal_map_id)


def _check_supported(lighting, backend):
    """Any backend but "kernels" and "reference" raises ValueError, as in
    the JAX package."""
    if backend not in ("kernels", "reference"):
        raise ValueError(f"unknown rasterizer backend: {backend}")
    if not isinstance(lighting.light, (lights_mod.PointLight,
                                       lights_mod.DirectionalLight)):
        raise TypeError(f"unknown light type {type(lighting.light)!r}")


def _attr_px(config):
    """The JAX pipeline's ``attr_px``: the per-pixel G-buffer (K2, K3 and
    their batches) needs per-pixel shading on 8x128 main-pass tiles; every
    other configuration takes the per-sample G-buffer (K3s)."""
    return (config.shading_per_pixel
            and (config.tile_h, config.tile_w) == (8, 128))


def _fused_ok(scene, lighting, config):
    """The JAX pipeline's ``fused_ok``: untextured scene, point light."""
    return (_attr_px(config) and config.fused_shade
            and len(scene.textures) == 0
            and isinstance(lighting.light, lights_mod.PointLight))


@dataclasses.dataclass(frozen=True)
class FramePrep:
    """Everything a frame's kernel launches and shading read, built on the
    device."""

    shadow_bins: object      # TileBins of the shadow pass, or None
    main_bins: object        # TileBins (with attribute tables) of the main pass
    uniforms: torch.Tensor   # f32[FU_LEN] shading uniforms (FU_* layout)
    light_dir: torch.Tensor  # f32[3] a directional light's direction, or None
    textures: tuple          # the scene's mip chains on the device
    fused: bool              # the main pass takes the fused kernel (K2)
    stats: dict              # prep-side stats (0-d tensors)
    backend: str = "kernels"
    # The reference backend's inputs in place of the bins: the shadow
    # pass's TriangleSetup (or None), the main pass's and its PassGeometry.
    shadow_setup: object = None
    main_setup: object = None
    pass_geom: object = None
    # The bins, uniforms and stats are a prep graph's outputs, which the
    # next frame of its shape rewrites: only this module's render functions
    # see such a prep (``_handed_over``).
    static: bool = False


def _copy_tables(prep: FramePrep) -> FramePrep:
    """``prep`` reading a copy of its bins, uniforms and stats (one launch
    on the card), which no replay rewrites."""
    tables = _tables(prep)
    copies = [torch.empty_like(t) for t in tables]
    _copy_words(copies, tables)
    return _with_tables(prep, copies)


# The bins' tables in the order ``_tables`` lists them.
_BIN_TABLES = ("vis", "attr", "tile_offsets", "tile_tris", "big_ids",
               "big_aabb", "big_n", "num_big_dropped")


def _tables(prep: FramePrep):
    """The device tensors of a kernels prep that its kernels and stats read:
    both passes' bins, the uniforms, the stats."""
    out = []
    for bins in (prep.shadow_bins, prep.main_bins):
        if bins is not None:
            out += [getattr(bins, k) for k in _BIN_TABLES
                    if getattr(bins, k) is not None]
    return out + [prep.uniforms, *prep.stats.values()]


def _with_tables(prep: FramePrep, tables) -> FramePrep:
    """``prep`` reading ``tables`` (in ``_tables``' order), no graph's."""
    it = iter(tables)

    def bins_of(bins):
        return None if bins is None else dataclasses.replace(bins, **{
            k: next(it) for k in _BIN_TABLES if getattr(bins, k) is not None})
    shadow_bins = bins_of(prep.shadow_bins)
    main_bins = bins_of(prep.main_bins)
    uniforms = next(it)
    return dataclasses.replace(
        prep, shadow_bins=shadow_bins, main_bins=main_bins,
        uniforms=uniforms, stats={k: next(it) for k in prep.stats},
        static=False)


def _copy_words(dst, src):
    """Copy every tensor of ``src`` into its ``dst`` bit for bit, in one
    launch on the card: both read as int32 words (a prep's tables all have
    4- or 8-byte elements)."""
    torch._foreach_copy_([d.reshape(-1).view(torch.int32) for d in dst],
                         [s.reshape(-1).view(torch.int32) for s in src])


def _host_side(scene, camera, lighting, config, shadow_config,
               shadow_target):
    """What the host forms for a frame's prep, on the CPU: (whether the
    shadow pass runs, the light's P @ V (zeros without a shadow pass), the
    camera's P @ V, the uniforms f32[FU_LEN])."""
    light = lighting.light
    light_anchor = lights_mod.light_anchor_position(
        light, shadow_target, shadow_config)
    shadow = _wants_shadow(scene)
    m = torch.zeros((4, 4), dtype=torch.float32)
    if shadow:
        light_view = lights_mod.light_view_matrix(
            light_anchor, torch.as_tensor(shadow_target, dtype=torch.float32))
        m = transforms.matmul(
            lights_mod.light_projection_matrix(shadow_config), light_view)
    vp = transforms.matmul(camera.projection_matrix(), camera.view_matrix())
    return shadow, m, vp, _fused_uniforms(m, camera, light_anchor, light,
                                          lighting, config)


def prepare_frame(scene: Scene, camera, lighting,
                  config: RenderConfig = RenderConfig(),
                  shadow_config: ShadowConfig = ShadowConfig(),
                  displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                  backend="kernels", device="cuda",
                  main_geom=None) -> FramePrep:
    """The host-side part of a frame: vertex stage, clipping, triangle
    setup and binning of both passes (the reference backend bins nothing),
    and the uniforms. No kernel runs.

    ``main_geom`` (a ``PackedGeometry`` on ``device``, e.g. a band's pruned
    soup from ``parallel.sharding.prune_to_band``) replaces the scene's
    geometry in the main pass only: the shadow pass always takes the whole
    scene, since a caster outside the camera's view still shadows it.

    On a CUDA device with the kernels backend the prep's device work is a
    CUDA graph (``PREP_GRAPH``) from the second frame of its shape
    (``prep_graph_key``) on: captured then, and replayed for every later
    one, with the frame's displacement, matrices and uniforms sent up in
    one upload and its geometry in one device copy. The tables returned
    are then a copy of the graph's outputs (one launch), the caller's to
    keep. Elsewhere (the CPU, the reference backend, a shape's first
    frame) the prep runs op by op, with the same results."""
    with annotate("mr/prep"):
        device = resolve_device(device)
        prep = _prepare(scene, camera, lighting, config, shadow_config,
                        displacement, shadow_target, backend, device,
                        main_geom, graphed=(device.type == "cuda"
                                            and backend == "kernels"))
        if prep.static and not _HAND_OVER.get():
            prep = _copy_tables(prep)
        return prep


# Set while one of this module's render functions calls ``prepare_frame``:
# each consumes or copies the prep before the next frame of its shape, so
# ``prepare_frame`` hands it a prep graph's outputs uncopied.
_HAND_OVER = contextvars.ContextVar("_HAND_OVER", default=False)


@contextlib.contextmanager
def _handed_over():
    token = _HAND_OVER.set(True)
    try:
        yield
    finally:
        _HAND_OVER.reset(token)


def _prepare(scene, camera, lighting, config, shadow_config, displacement,
             shadow_target, backend, device, main_geom, graphed):
    """``prepare_frame`` on a resolved ``device``, uncopied: through its
    prep graph if ``graphed`` and the graph cache says so, else op by
    op."""
    _check_supported(lighting, backend)
    scene = scene.to(device)
    light = lighting.light
    shadow, m, vp, uniforms = _host_side(scene, camera, lighting, config,
                                         shadow_config, shadow_target)
    n_tris = (scene if main_geom is None else main_geom).num_triangles
    prep = None
    if graphed:
        prep = _graphed_prep(scene, displacement, vp, m, uniforms, shadow,
                             config, device, main_geom, n_tris)
    if prep is None:
        prep = _prep_device(
            scene, displacement, vp.to(device), m.to(device) if shadow
            else None, uniforms.to(device), shadow, config,
            backend == "reference", main_geom,
            torch.tensor(n_tris, dtype=torch.int32, device=device))
    light_dir = None
    if isinstance(light, lights_mod.DirectionalLight):
        light_dir = torch.as_tensor(light.direction,
                                    dtype=torch.float32).to(device)
    return dataclasses.replace(
        prep, light_dir=light_dir, textures=scene.textures,
        fused=backend != "reference" and _fused_ok(scene, lighting, config))


def _prep_device(scene, displacement, vp, light_m, uniforms, shadow, config,
                 reference, main_geom, n_tris) -> FramePrep:
    """The prep's device work: bake, both passes' clipping and setup, the
    binning (none for the reference backend) and the stats. ``displacement``:
    a number or an f32[] on the device; ``vp``, ``light_m``: the camera's
    and the light's P @ V, f32[4,4] on the device (``light_m`` None without
    a shadow pass); ``uniforms`` f32[FU_LEN] and ``n_tris`` (the
    ``num_triangles`` stat) on the device. It neither syncs nor uploads, so
    a prep graph captures it whole. Returns the FramePrep without
    ``light_dir``, ``textures`` and ``fused``."""
    device = uniforms.device
    zero = (torch.zeros((), dtype=torch.int32, device=device) if reference
            else None)
    with annotate("mr/prep/bake"):
        geom_full = bake(scene, displacement)
    geom = geom_full if main_geom is None else main_geom
    stats = {"num_triangles": n_tris}

    shadow_bins = shadow_setup = None
    if shadow:
        with annotate("mr/prep/shadow"):
            clip_l = transforms.transform_points(light_m, geom_full.world)
            clip_l2, _, parent_l = clip_near(clip_l.reshape(-1, 3, 4))
            size = config.shadow_map_size
            setup_l = setup_triangles(clip_l2, size, size,
                                      cull_backfaces=False,
                                      near_eps=config.near_eps)
            # Only shadow casters contribute (the reference encodes only
            # the cube into the shadow pass, mtl_engine.mm:785-787).
            setup_l = setup_l.replace(
                valid=setup_l.valid & geom_full.cast_shadow[
                    parent_l.to(torch.int64)])
        if reference:
            shadow_setup = setup_l
            stats["shadow_big_dropped"] = zero
        else:
            with annotate("mr/prep/shadow_bin"):
                shadow_bins = bin_triangles(
                    setup_l, build_tri_fields(setup_l), size, size,
                    config.shadow_tile_w, config.shadow_tile_h,
                    span_cap=SHADOW_SPAN_CAP,
                    big_capacity=config.big_capacity)
            stats["shadow_big_dropped"] = shadow_bins.num_big_dropped

    main_bins = None
    with annotate("mr/prep/main"):
        if reference:
            setup, pg, gstats = prepare_main_pass(geom, vp, config,
                                                  with_stats=True)
            stats.update(setup_cuda.main_pass_stats(setup, gstats))
        else:
            # The kernel on the card (the chain, its twin, elsewhere).
            tables = setup_cuda.main_pass_tables(geom, vp, config)
            stats.update(tables.stats)
    if reference:
        stats["big_dropped"] = zero
    else:
        with annotate("mr/prep/main_bin"):
            main_bins = bin_triangles(
                tables, tables.vis, config.width, config.height,
                config.tile_w, config.tile_h, span_cap=config.span_cap,
                big_capacity=config.big_capacity, attr_fields=tables.attr)
        stats["big_dropped"] = main_bins.num_big_dropped
    return FramePrep(shadow_bins, main_bins, uniforms, None, (), False,
                     stats, "reference" if reference else "kernels",
                     shadow_setup,
                     *((setup, pg) if reference else (None, None)))


# --------------------------------------------------------------------------
# The prep graph
# --------------------------------------------------------------------------
#
# Every shape in ``_prep_device`` follows from the scene's triangle counts,
# the config and the tile grid, and no op in it syncs with the host, so on
# the card it is captured once per shape as a CUDA graph and replayed: one
# graph launch in place of ~930 kernel launches a frame. The graph reads
# static inputs that each frame fills: the scene's tensors by one device
# copy, and the displacement, both P @ V products (formed on the host as
# the op-by-op prep forms them) and the uniforms by one upload from pinned
# memory. Its outputs are the same tensors at every replay.

# The RenderConfig fields the prep's device work reads (the rest reach it
# through the uniforms, or not at all).
_PREP_CONFIG_FIELDS = ("width", "height", "cull_backfaces", "near_eps",
                       "xyclip_capacity", "guard_band_px", "shadow_map_size",
                       "shadow_tile_w", "shadow_tile_h", "tile_w", "tile_h",
                       "span_cap", "big_capacity")
# A frame's upload: displacement, camera P @ V, light P @ V, uniforms.
_UP_DISP, _UP_VP, _UP_LIGHT, _UP_UNIFORMS = 0, 1, 17, 33
_UP_LEN = _UP_UNIFORMS + raster_cuda.FU_LEN


def prep_graph_key(scene: Scene, config: RenderConfig, device,
                   main_geom=None):
    """What fixes a prep's shapes and control flow, so which prep graph a
    frame replays: each instance's vertex and triangle counts, its
    displacement and shadow flags and its material's kind and texture and
    normal-map ids (the bake writes them per triangle), whether the shadow
    pass runs, the config fields the prep reads, the device and
    ``main_geom``'s vertex and triangle counts. Frames that differ in
    displacement, camera, light or colors share a graph."""
    instances = tuple(
        (i.mesh.num_vertices, i.mesh.num_triangles, i.use_displacement,
         i.cast_shadow, i.material.kind, i.material.texture_id,
         i.material.normal_map_id) for i in scene.instances)
    geom = (None if main_geom is None
            else (main_geom.world.shape[0], main_geom.num_triangles))
    return (str(torch.device(device)), instances, _wants_shadow(scene),
            tuple(getattr(config, f) for f in _PREP_CONFIG_FIELDS), geom)


def _geometry_tensors(scene: Scene, main_geom):
    """The device tensors of a frame's geometry that its prep graph reads:
    each instance's positions, uvs, normals, model matrix and material
    color, then ``main_geom``'s fields."""
    out = []
    for inst in scene.instances:
        out += [inst.mesh.positions, inst.mesh.uvs, inst.mesh.normals,
                inst.model_matrix, inst.material.color]
    if main_geom is not None:
        out += [getattr(main_geom, f.name)
                for f in dataclasses.fields(main_geom)]
    return out


def _with_geometry(scene: Scene, main_geom, tensors):
    """(``scene`` without its textures, ``main_geom``) reading ``tensors``
    (in ``_geometry_tensors``' order)."""
    instances = []
    for k, inst in enumerate(scene.instances):
        pos, uvs, nrm, model, color = tensors[5 * k:5 * k + 5]
        instances.append(dataclasses.replace(
            inst, mesh=Mesh(pos, uvs, nrm), model_matrix=model,
            material=dataclasses.replace(inst.material, color=color)))
    rest = tensors[5 * len(instances):]
    return (Scene(instances=tuple(instances)),
            PackedGeometry(*rest) if main_geom is not None else None)


def _upload(displacement, vp, light_m, uniforms):
    """A frame's one upload, f32[_UP_LEN] on the host: the displacement
    (taken as f32, as ``bake`` takes it), the camera's and the light's
    P @ V, the uniforms."""
    return torch.cat([torch.as_tensor(displacement, dtype=torch.float32)
                      .reshape(1).cpu(), vp.reshape(-1), light_m.reshape(-1),
                      uniforms])


def _graph_body(scene, main_geom, upload, shadow, config, n_tris):
    """``_prep_device`` as a prep graph runs it: on ``scene`` and
    ``main_geom`` reading the static geometry and on the static ``upload``
    (``_upload``'s layout, on the device)."""
    return dataclasses.replace(_prep_device(
        scene, upload[_UP_DISP], upload[_UP_VP:_UP_LIGHT].view(4, 4),
        upload[_UP_LIGHT:_UP_UNIFORMS].view(4, 4) if shadow else None,
        upload[_UP_UNIFORMS:], shadow, config, False, main_geom, n_tris),
        static=True)


class PrepGraph:
    """One prep captured as a CUDA graph: its static inputs, the graph and
    the ``FramePrep`` that every replay rewrites."""

    def __init__(self, scene, shadow, config, device, main_geom, n_tris):
        self.device, self.shadow, self.config = device, shadow, config
        self.geometry = [torch.empty_like(t)
                         for t in _geometry_tensors(scene, main_geom)]
        self.scene, self.main_geom = _with_geometry(scene, main_geom,
                                                    self.geometry)
        self.upload = torch.empty(_UP_LEN, dtype=torch.float32,
                                  device=device)
        self.n_tris = torch.tensor(n_tris, dtype=torch.int32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.prep = None

    def fill(self, geometry, frame):
        """Set the inputs: ``geometry`` (``_geometry_tensors``) copied on
        the device, ``frame`` (``_upload``'s arguments) packed in pinned
        memory and sent up in one asynchronous copy (PyTorch's pinned
        memory cache keeps the block until the copy has run)."""
        torch._foreach_copy_(self.geometry, geometry)
        self.upload.copy_(_upload(*frame).pin_memory(), non_blocking=True)

    def _run(self):
        return _graph_body(self.scene, self.main_geom, self.upload,
                           self.shadow, self.config, self.n_tris)

    def capture(self):
        """Run the prep on the filled inputs once op by op on a side stream
        (PyTorch's warm-up before a capture), capture it, and replay it."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(self.graph):
                self.prep = self._run()
            self.graph.replay()


class PrepGraphs:
    """The prep graphs by ``prep_graph_key``, the least recently used
    first, at most ``size`` (each graph's memory pool holds every
    intermediate of its prep).

    A shape is captured at its second frame (``due``); its first runs op
    by op, so a one-off frame (a single render, a session's frame after a
    resize) costs what it did before graphs, not a capture (tens of op-by-
    op preps). A shape whose graph was freed runs op by op from then on,
    so shapes taking turns beyond ``size`` never recapture in turn.
    ``seen`` remembers the last ``remembered`` shapes without a graph;
    ``captures`` and ``replays`` count the graphed frames."""

    def __init__(self, size=4, remembered=64):
        self.size, self.remembered = size, remembered
        self.graphs = collections.OrderedDict()
        # key -> frames run op by op, or None once its graph was freed.
        self.seen = collections.OrderedDict()
        self.captures = 0
        self.replays = 0

    def get(self, key):
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def due(self, key):
        """Count a frame of ``key``, which has no graph: whether it
        captures one (its second frame, if its graph was never freed)."""
        frames = self.seen.pop(key, 0)
        self.seen[key] = None if frames is None else frames + 1
        while len(self.seen) > self.remembered:
            self.seen.popitem(last=False)
        return frames == 1

    def add(self, key, make):
        """Free the least recently used graphs beyond ``size - 1``, then
        ``make()`` this key's graph and keep it."""
        while len(self.graphs) >= self.size:
            freed, _ = self.graphs.popitem(last=False)
            self.seen.pop(freed, None)
            self.seen[freed] = None
        graph = self.graphs[key] = make()
        self.captures += 1
        return graph

    def clear(self):
        """Free every graph and forget every shape."""
        self.graphs.clear()
        self.seen.clear()


# The process's prep graphs: every renderer of a process shares them, so a
# stream's warm-up captures what its later frames replay.
PREP_GRAPH = PrepGraphs()


def _graphed_prep(scene, displacement, vp, light_m, uniforms, shadow,
                  config, device, main_geom, n_tris):
    """The frame's prep through its prep graph (a ``static`` FramePrep),
    captured first at the shape's second frame; None where the frame runs
    op by op (``PrepGraphs.due``)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = prep_graph_key(scene, config, device, main_geom)
    graph = PREP_GRAPH.get(key)
    if graph is None and not PREP_GRAPH.due(key):
        return None
    frame = (displacement, vp, light_m, uniforms)
    geometry = _geometry_tensors(scene, main_geom)
    if graph is None:
        with annotate("mr/prep/capture"):
            def make():
                g = PrepGraph(scene, shadow, config, device, main_geom,
                              n_tris)
                g.fill(geometry, frame)
                g.capture()
                return g
            graph = PREP_GRAPH.add(key, make)
    else:
        with annotate("mr/prep/replay"):
            graph.fill(geometry, frame)
            graph.graph.replay()
        PREP_GRAPH.replays += 1
    return graph.prep


def _shadow_pass(shadow_bins, config, stats):
    """K1 on one frame's shadow bins, or K4 on a batch's, depth alone (no
    winner plane, as the JAX ``rasterize_depth_batch`` returns): the shadow
    map f32[S, S] or f32[F, S, S] (None without shadow bins)."""
    if shadow_bins is None:
        return None
    size = config.shadow_map_size
    with annotate("mr/raster"):
        if raster_cuda.is_batch(shadow_bins):
            depth, _ = raster_cuda.raster_depth_batch(
                shadow_bins, size, size, ((0.5, 0.5),), clear_depth=1.0,
                with_winner=False)
            shadow_map = depth[:, 0]
        else:
            depth, _ = raster_cuda.raster_depth(
                shadow_bins, size, size, ((0.5, 0.5),), clear_depth=1.0,
                with_winner=False)
            shadow_map = depth[0]
        stats["shadow_min_depth"] = torch.amin(shadow_map, dim=(-2, -1))
    return shadow_map


def _split_shade(ch, uniforms, shadow_map, textures, light_dir, config,
                 tiled_sampler=True):
    """The split path's fragment stage on channel planes: [H, W] planes
    with uniforms f32[FU_LEN], or [F, H, W] planes with per-frame uniforms
    f32[F, FU_LEN] (equal in every frame but the camera position) and
    per-frame shadow maps, or [S, H, W] sample planes (no ``cov_frac``),
    box-resolved here when every sample was shaded. ``tiled_sampler``:
    as ``shade.shade_channels``'s. Returns rgba f32[..., H, W, 4]."""
    fc = raster_cuda
    if uniforms.dim() == 2:
        camera_pos = uniforms[:, fc.FU_CAM:fc.FU_CAM + 3].T[:, :, None, None]
        u = uniforms[0]
    else:
        u = uniforms
        camera_pos = u[fc.FU_CAM:fc.FU_CAM + 3]
    shadow_ctx = None
    if shadow_map is not None:
        shadow_ctx = shade.ShadowContext(
            depth_map=shadow_map,
            light_m=u[fc.FU_M:fc.FU_M + 16].reshape(4, 4))
    r, g, b, a = shade.shade_channels(
        ch, camera_pos=camera_pos,
        light_pos=u[fc.FU_LPOS:fc.FU_LPOS + 3],
        light_color=u[fc.FU_LCOL:fc.FU_LCOL + 3],
        ambient_intensity=u[fc.FU_AMB], shininess=u[fc.FU_SHIN],
        clear_color=u[fc.FU_CLEAR:fc.FU_CLEAR + 4],
        shadow=shadow_ctx, textures=textures,
        shadow_bias=u[fc.FU_BIAS], shadow_factor_value=u[fc.FU_FACTOR],
        light_dir=light_dir, shadow_per_pixel=config.shadow_per_pixel,
        per_pixel=config.shading_per_pixel, tiled_sampler=tiled_sampler)
    if ch.get("cov_frac") is None and r.dim() == 3:
        # Sample planes: the MSAA box resolve, per channel plane.
        r, g, b, a = (torch.mean(c, dim=0) for c in (r, g, b, a))
    return torch.stack([r, g, b, a], dim=-1)


def _render_reference(prep: FramePrep, config: RenderConfig):
    """The reference backend's passes and shading of one prepared frame:
    (rgba, stats). No kernel runs."""
    stats = dict(prep.stats)
    shadow_map = None
    if prep.shadow_setup is not None:
        size = config.shadow_map_size
        shadow_map = reference_cpu.rasterize_depth_brute_force(
            prep.shadow_setup, size, size,
            anchor=(config.shadow_tile_w, config.shadow_tile_h))
        stats["shadow_min_depth"] = torch.amin(shadow_map)
    gbuf = _raster_gbuffer_reference(prep.main_setup, prep.pass_geom, config)
    stats["covered_fraction"] = torch.mean(gbuf.covered.to(torch.float32))
    return _split_shade(shade.channels_from_gbuffer(gbuf), prep.uniforms,
                        shadow_map, prep.textures, prep.light_dir, config,
                        tiled_sampler=False), stats


def _render_prepared(prep: FramePrep, config: RenderConfig):
    """The kernels (or the reference backend's passes) and shading of one
    prepared frame: (rgba, stats)."""
    if prep.backend != "kernels":
        return _render_reference(prep, config)
    stats = dict(prep.stats)
    if prep.static:
        # The caller keeps the stats: copies, which no replay rewrites.
        copies = [torch.empty_like(v) for v in stats.values()]
        _copy_words(copies, list(stats.values()))
        stats = dict(zip(stats, copies))
    shadow_map = _shadow_pass(prep.shadow_bins, config, stats)
    samples = tuple(config.sample_positions)
    if prep.fused:
        with annotate("mr/raster"):
            rgba, covf = raster_cuda.render_fused(
                prep.main_bins, prep.uniforms, shadow_map, config.width,
                config.height, samples, clear_depth=config.clear_depth)
        stats["covered_fraction"] = torch.mean(covf)
        return rgba, stats
    if _attr_px(config):
        gout, _, _ = raster_cuda.raster_gbuffer(
            prep.main_bins, config.width, config.height, samples,
            clear_depth=config.clear_depth)
        ch = raster_cuda.channels_from_gout_px(gout, len(samples))
        stats["covered_fraction"] = torch.mean(ch["cov_frac"])
    else:
        gout, _, winner = raster_cuda.raster_gbuffer_samples(
            prep.main_bins, config.width, config.height, samples,
            clear_depth=config.clear_depth)
        ch = raster_cuda.channels_from_gout(gout, winner)
        stats["covered_fraction"] = torch.mean(
            ch["covered"].to(torch.float32))
    return _split_shade(ch, prep.uniforms, shadow_map, prep.textures,
                        prep.light_dir, config), stats


def render_frame(scene: Scene, camera, lighting,
                 config: RenderConfig = RenderConfig(),
                 shadow_config: ShadowConfig = ShadowConfig(),
                 displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                 backend="kernels", device="cuda", main_geom=None):
    """Render one frame on ``device``. Returns (framebuffer f32[H,W,4] and a
    stats dict of 0-d tensors, both on ``device``). ``backend``:
    ``"kernels"`` or ``"reference"`` (module docstring); ``main_geom``: as
    ``prepare_frame``'s."""
    with annotate("mr/frame"):
        with _handed_over():
            prep = prepare_frame(scene, camera, lighting, config,
                                 shadow_config, displacement, shadow_target,
                                 backend, device, main_geom)
        return _render_prepared(prep, config)


def render(scene: Scene, camera, lighting,
           config: RenderConfig = RenderConfig(),
           shadow_config: ShadowConfig = ShadowConfig(),
           displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
           backend="kernels", device="cuda"):
    """The package-level entry point, ``render_frame`` under the JAX
    package's name (there a jitted wrapper whose default backend is its
    brute-force oracle; the port's default is the kernels, and
    ``backend="reference"`` takes its oracle)."""
    return render_frame(scene, camera, lighting, config, shadow_config,
                        displacement, shadow_target, backend, device)


# --------------------------------------------------------------------------
# Frame batches (``metalrenderer_tpu.passes.pipeline``'s batch API)
# --------------------------------------------------------------------------
#
# Every frame of a batch is prepared by ``prepare_frame`` (a loop over the
# frames; vectorizing the prep is ROADMAP A13), its bins are stacked, and the
# kernels run once per batch: K4 for the shadow maps, then K6 (fused
# branch) or K5 + the batch-transparent split shading with K8 and one K9
# per texture and pass (px branch). Each frame is bit-equal to
# ``render_frame`` of the same frame. Batch stats carry per-frame leaves.


def fused_batch_eligible(scene: Scene, lighting, config: RenderConfig,
                         camera=None) -> bool:
    """Can (scene, lighting, config) take ``render_frame_batch_fused``? The
    fused branch's condition (untextured, point light, ``fused_shade``)
    plus ``px_batch_eligible``'s."""
    return (_fused_ok(scene, lighting, config)
            and px_batch_eligible(scene, lighting, config, camera))


def px_batch_eligible(scene: Scene, lighting, config: RenderConfig,
                      camera=None) -> bool:
    """Can (scene, lighting, config) take ``render_frame_batch_px``?
    Per-pixel shading on 8x128 main-pass tiles (K5's layout) and, when
    ``camera`` is given, an orbit camera (frames differ by ``theta``)."""
    ok = _attr_px(config)
    if camera is not None:
        ok = ok and hasattr(camera, "theta")
    return ok


def _batch_frames(camera, displacements, thetas, cameras):
    """Per-frame displacements (f32 values) and cameras: ``cameras`` as
    given, else the orbit ``camera`` at each of ``thetas`` (f32)."""
    disps = [float(d) for d in torch.as_tensor(
        displacements, dtype=torch.float32).reshape(-1)]
    if cameras is not None:
        cams = list(cameras)
    else:
        cams = [dataclasses.replace(camera, theta=float(t))
                for t in torch.as_tensor(thetas,
                                         dtype=torch.float32).reshape(-1)]
    if len(cams) != len(disps) or not disps:
        raise ValueError(f"{len(disps)} displacements for {len(cams)} "
                         "cameras: need one of each per frame, at least one")
    return disps, cams


@dataclasses.dataclass(frozen=True)
class BatchPrep:
    """A batch's ``FramePrep``s stacked for the batch kernels."""

    shadow_bins: object      # stacked TileBins of the shadow passes, or None
    main_bins: object        # stacked TileBins of the main passes
    uniforms: torch.Tensor   # f32[F, FU_LEN]
    light_dir: torch.Tensor  # f32[3] or None (frame 0's)
    textures: tuple          # frame 0's mip chains
    stats: dict              # prep-side stats, leaves [F]


def _check_batch_backend(backend):
    if backend != "kernels":
        raise ValueError("the batch kernels need backend='kernels'; "
                         "render_batch renders the reference frame by frame")


def _stack_preps(preps, frames) -> BatchPrep:
    """Stack a batch's ``frames`` preps for the batch kernels (the tables
    of ``raster_cuda.stack_bins``). ``preps``, an iterable, is consumed
    here: each prep is copied into its frame's slot of the stacked tables
    (one launch on the card) as it comes, so that a graphed prep is kept
    before the next frame's replay rewrites it."""
    preps = iter(preps)
    first = next(preps)
    slots = [torch.empty((frames, *t.shape), dtype=t.dtype, device=t.device)
             for t in _tables(first)]
    n = 0
    for f, prep in enumerate(itertools.chain([first], preps)):
        if (prep.shadow_bins is None) != (first.shadow_bins is None):
            raise ValueError("some frames of the batch have a shadow pass, "
                             "others not")
        tables = _tables(prep)
        if f >= frames or [t.shape for t in tables] != [
                s.shape[1:] for s in slots]:
            raise ValueError(f"frame {f} of a batch of {frames}: its "
                             "tables do not fit the batch's")
        with annotate("mr/stack"):
            _copy_words([s[f] for s in slots], tables)
        n = f + 1
    if n != frames:
        raise ValueError(f"{n} preps for a batch of {frames} frames")
    stacked = _with_tables(first, slots)

    def batch_bins(bins):
        return None if bins is None else dataclasses.replace(
            bins, big_n=bins.big_n.reshape(frames))
    return BatchPrep(
        shadow_bins=batch_bins(stacked.shadow_bins),
        main_bins=batch_bins(stacked.main_bins), uniforms=stacked.uniforms,
        light_dir=first.light_dir, textures=first.textures,
        stats=stacked.stats)


def _stack_stats(stats):
    return {k: torch.stack([s[k] for s in stats]) for k in stats[0]}


def render_frame_batch_fused(scene: Scene, camera, lighting,
                             config: RenderConfig,
                             shadow_config: ShadowConfig,
                             displacements, thetas,
                             shadow_target=(0.0, 0.0, -1.0),
                             scene_fn=None, lighting_fn=None,
                             frame_params=None, cameras=None,
                             backend="kernels", device="cuda"):
    """A batch of frames through the fused branch in two launches: K4 (the
    shadow maps, if the scene casts shadows) and K6.

    ``displacements``, ``thetas``: per-frame audio displacement and orbit
    angle (sequences of F numbers, taken as f32); ``cameras``: a sequence
    of F cameras that replaces ``thetas``. Per-frame scene and lighting
    (the audio-reactive shape: light color and emissive material follow
    the audio): ``frame_params``, a sequence of F values, with
    ``scene_fn(param) -> Scene`` and/or ``lighting_fn(param) -> Lighting``;
    ``scene`` and ``lighting`` are then the templates that decide
    eligibility, and every frame is ``render_frame`` of its own scene and
    lighting. Raises ValueError unless ``fused_batch_eligible`` and
    ``backend="kernels"``. Returns (rgba f32[F, H, W, 4], stats with
    per-frame leaves)."""
    _check_batch_backend(backend)
    if not fused_batch_eligible(scene, lighting, config):
        raise ValueError("the fused batch needs an untextured scene, a point "
                         "light, fused_shade and per-pixel 8x128 tiles")
    disps, cams = _batch_frames(camera, displacements, thetas, cameras)
    params = ([0.0] * len(disps) if frame_params is None
              else list(frame_params))
    if len(params) != len(disps):
        raise ValueError(f"{len(params)} frame_params for {len(disps)} "
                         "frames")
    def preps():
        for d, cam, p in zip(disps, cams, params):
            with _handed_over():
                prep = prepare_frame(
                    scene_fn(p) if scene_fn else scene, cam,
                    lighting_fn(p) if lighting_fn else lighting, config,
                    shadow_config, d, shadow_target, backend, device)
            if not prep.fused:
                raise ValueError("scene_fn/lighting_fn left the fused "
                                 "branch")
            yield prep
    batch = _stack_preps(preps(), len(disps))
    stats = dict(batch.stats)
    shadow_maps = _shadow_pass(batch.shadow_bins, config, stats)
    with annotate("mr/raster"):
        rgba, covf = raster_cuda.render_fused_batch(
            batch.main_bins, batch.uniforms, shadow_maps, config.width,
            config.height, tuple(config.sample_positions),
            clear_depth=config.clear_depth)
    stats["covered_fraction"] = torch.mean(covf, dim=(1, 2))
    return rgba, stats


def render_frame_batch_px(scene: Scene, camera, lighting,
                          config: RenderConfig,
                          shadow_config: ShadowConfig,
                          displacements, thetas,
                          shadow_target=(0.0, 0.0, -1.0), cameras=None,
                          backend="kernels", device="cuda"):
    """A batch of frames through the split branch (textures, normal maps,
    directional lights, ``fused_shade=False``): K4, K5 for every frame's
    G-buffer, then the split shading once on [F, H, W] planes with K8 for
    the shadow test and one K9 per texture and pass. Arguments as
    ``render_frame_batch_fused`` (one scene and lighting for all frames).
    Raises ValueError unless ``px_batch_eligible`` and
    ``backend="kernels"``. Returns (rgba f32[F, H, W, 4], stats with
    per-frame leaves)."""
    _check_batch_backend(backend)
    if not px_batch_eligible(scene, lighting, config):
        raise ValueError("the px batch needs per-pixel shading on 8x128 "
                         "main-pass tiles")
    disps, cams = _batch_frames(camera, displacements, thetas, cameras)

    def preps():
        for d, cam in zip(disps, cams):
            with _handed_over():
                prep = prepare_frame(scene, cam, lighting, config,
                                     shadow_config, d, shadow_target,
                                     backend, device)
            yield prep
    batch = _stack_preps(preps(), len(disps))
    stats = dict(batch.stats)
    shadow_maps = _shadow_pass(batch.shadow_bins, config, stats)
    samples = tuple(config.sample_positions)
    gout = raster_cuda.raster_gbuffer_batch(
        batch.main_bins, config.width, config.height, samples,
        clear_depth=config.clear_depth)
    # channels_from_gout_px reads rows on axis 0: [16, F, H, W] gives
    # [F, H, W] channels.
    ch = raster_cuda.channels_from_gout_px(gout.transpose(0, 1), len(samples))
    stats["covered_fraction"] = torch.mean(ch["cov_frac"], dim=(1, 2))
    return _split_shade(ch, batch.uniforms, shadow_maps, batch.textures,
                        batch.light_dir, config), stats


def render_frame_batch_hoisted(scene: Scene, camera, lighting,
                               config: RenderConfig,
                               shadow_config: ShadowConfig,
                               displacements, thetas,
                               shadow_target=(0.0, 0.0, -1.0),
                               frame_map=None, backend="kernels",
                               device="cuda"):
    """The fused branch's frames prepared first, all of them, then one K1
    and one K2 per frame: the prep of ``render_frame_batch_fused`` without
    its kernel fold, so the two shapes compare what the fold buys.
    ``frame_map``: optional fn(rgba f32[H, W, 4]) -> tensor applied to
    each frame. Raises ValueError unless ``fused_batch_eligible``. Returns
    (rgba f32[F, H, W, 4], or the stacked ``frame_map`` outputs, and stats
    with per-frame leaves)."""
    if not fused_batch_eligible(scene, lighting, config):
        raise ValueError("the hoisted batch needs an untextured scene, a "
                         "point light, fused_shade and per-pixel 8x128 "
                         "tiles")
    disps, cams = _batch_frames(camera, displacements, thetas, None)
    preps = [prepare_frame(scene, cam, lighting, config, shadow_config, d,
                           shadow_target, backend, device)
             for d, cam in zip(disps, cams)]
    outs, stats = [], []
    for prep in preps:
        rgba, st = _render_prepared(prep, config)
        outs.append(rgba if frame_map is None else frame_map(rgba))
        stats.append(st)
    return torch.stack(outs), _stack_stats(stats)


def render_frame_batch_chunked(scene: Scene, camera, lighting,
                               config: RenderConfig,
                               shadow_config: ShadowConfig,
                               displacements, thetas, chunk,
                               shadow_target=(0.0, 0.0, -1.0),
                               cameras=None, frame_map=None,
                               backend="kernels", device="cuda"):
    """The batch in sub-batches of ``chunk`` frames, each one fused or px
    batch (whichever the scene takes); bounds the device memory of long
    batches. ``frame_map``: optional fn(rgba f32[C, H, W, 4]) -> tensor
    applied to each sub-batch. Raises ValueError unless ``chunk`` divides
    the frame count and the scene takes a batch branch. Returns (rgba
    f32[F, H, W, 4], or the ``frame_map`` outputs stacked [F/chunk, ...],
    and stats with per-frame leaves)."""
    disps, cams = _batch_frames(camera, displacements, thetas, cameras)
    F = len(disps)
    if not (isinstance(chunk, int) and chunk > 0 and F % chunk == 0):
        raise ValueError(f"frame count {F} not divisible by chunk {chunk!r}")
    if fused_batch_eligible(scene, lighting, config):
        fn = render_frame_batch_fused
    elif px_batch_eligible(scene, lighting, config):
        fn = render_frame_batch_px
    else:
        raise ValueError("scene/config not eligible for a batch branch")
    outs, stats = [], []
    for i in range(0, F, chunk):
        rgba, st = fn(scene, camera, lighting, config, shadow_config,
                      disps[i:i + chunk], None, shadow_target=shadow_target,
                      cameras=cams[i:i + chunk], backend=backend,
                      device=device)
        outs.append(rgba if frame_map is None else frame_map(rgba))
        stats.append(st)
    out = torch.cat(outs) if frame_map is None else torch.stack(outs)
    return out, {k: torch.cat([s[k] for s in stats]) for k in stats[0]}


def render_batch(scene: Scene, camera, lighting,
                 displacements, thetas=None,
                 config: RenderConfig = RenderConfig(),
                 shadow_config: ShadowConfig = ShadowConfig(),
                 shadow_target=(0.0, 0.0, -1.0), cameras=None,
                 backend="kernels", chunk="auto", device="cuda"):
    """Render a batch of frames in the fewest kernel launches available:
    the fused batch (untextured point-light scenes: K4 + K6), else the px
    batch (K4 + K5 + K8 + K9), else ``render_frame`` frame by frame
    (supersampled shading and main-pass tiles other than 8x128: K1 + K3s +
    K7 per frame, and every frame of the reference backend). Every frame
    equals ``render_frame`` of the same frame.

    ``displacements``: F numbers; ``thetas``: F orbit angles (default: the
    camera's); ``cameras``: F cameras, replacing ``thetas``. ``chunk``:
    "auto" or None folds the whole batch into one launch per kernel (the
    card has no scratch-memory budget to respect); an int n splits it into
    sub-batches of n frames (``render_frame_batch_chunked``) when n divides
    the frame count, to bound device memory; the frames are the same
    either way. Returns (rgba f32[F, H, W, 4], stats with per-frame
    leaves)."""
    with annotate("mr/batch"):
        if not (chunk in ("auto", None) or (isinstance(chunk, int)
                                            and chunk > 0)):
            raise ValueError(f"chunk: 'auto', None or a positive int, not "
                             f"{chunk!r}")
        F = torch.as_tensor(displacements).numel()
        if cameras is None and not hasattr(camera, "theta"):
            cameras = [camera] * F
        if thetas is None and cameras is None:
            thetas = [camera.theta] * F
        cam = camera if cameras is None else None
        fused = fused_batch_eligible(scene, lighting, config, cam)
        if backend == "kernels" and (fused or px_batch_eligible(
                scene, lighting, config, cam)):
            kw = dict(shadow_target=shadow_target, cameras=cameras,
                      backend=backend, device=device)
            if isinstance(chunk, int) and F > chunk and F % chunk == 0:
                return render_frame_batch_chunked(
                    scene, camera, lighting, config, shadow_config,
                    displacements, thetas, chunk, **kw)
            fn = render_frame_batch_fused if fused else render_frame_batch_px
            return fn(scene, camera, lighting, config, shadow_config,
                      displacements, thetas, **kw)
        disps, cams = _batch_frames(camera, displacements, thetas, cameras)
        outs = [render_frame(scene, c, lighting, config, shadow_config, d,
                             shadow_target, backend, device)
                for d, c in zip(disps, cams)]
        return (torch.stack([fb for fb, _ in outs]),
                _stack_stats([st for _, st in outs]))
