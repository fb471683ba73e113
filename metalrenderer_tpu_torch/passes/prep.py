"""The kernels backend's frame prep: everything a frame's kernel launches
and shading read, built on the render device by ``prepare`` (the host's
matrices and uniforms, the bake, both passes' clipping, setup and
binning). On the card its device work is a CUDA graph per scene shape,
captured at the shape's second frame and replayed after (``PREP_GRAPH``);
elsewhere, and at a shape's first frame, it runs op by op, bit-equal.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..math import transforms
from ..raster import raster_cuda, setup_cuda
from ..raster.binning import TileBins, bin_triangles, build_tri_fields
from ..raster.geometry import clip_near, setup_triangles
from ..scene import lights as lights_mod
from ..scene.materials import BLINN_PHONG_SHADOW
from ..scene.mesh import Mesh
from ..scene.scene import PackedGeometry, Scene, bake
from ..utils.cuda_graphs import GraphCache, capture_graph
from ..utils.profiling import annotate


# The shadow pass bins with the JAX kernels' default span cap, whatever
# config.span_cap says: every JAX shadow pass (rasterize_tiles,
# rasterize_depth_batch) leaves span_cap at its default of 8.
SHADOW_SPAN_CAP = 8


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
    # The bins, uniforms and stats are a prep graph's outputs, which the
    # next frame of its shape rewrites: ``prepare_frame`` hands such a prep
    # to ``passes.pipeline``'s own render functions alone.
    static: bool = False


def attr_px(config):
    """The JAX pipeline's ``attr_px``: the per-pixel G-buffer (K2, K3 and
    their batches) needs per-pixel shading on 8x128 main-pass tiles; every
    other configuration takes the per-sample G-buffer (K3s)."""
    return (config.shading_per_pixel
            and (config.tile_h, config.tile_w) == (8, 128))


def fused_ok(scene, lighting, config):
    """The JAX pipeline's ``fused_ok``: untextured scene, point light."""
    return (attr_px(config) and config.fused_shade
            and len(scene.textures) == 0
            and isinstance(lighting.light, lights_mod.PointLight))


def wants_shadow(scene: Scene):
    """Does any instance cast AND any instance receive shadows?"""
    casts = any(i.cast_shadow for i in scene.instances)
    receives = any(
        i.material.kind == BLINN_PHONG_SHADOW for i in scene.instances
    )
    return casts and receives


def host_side(scene, camera, lighting, config, shadow_config,
              shadow_target):
    """What the host forms for a frame's prep, on the CPU: (whether the
    shadow pass runs, the light's P @ V (zeros without a shadow pass), the
    camera's P @ V, the shading uniforms f32[FU_LEN] in raster_cuda's FU_*
    layout: the fused kernel's, read by the split path's shading too)."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    light = lighting.light
    light_anchor = lights_mod.light_anchor_position(
        light, shadow_target, shadow_config)
    shadow = wants_shadow(scene)
    m = torch.zeros((4, 4), dtype=torch.float32)
    if shadow:
        light_view = lights_mod.light_view_matrix(
            light_anchor, torch.as_tensor(shadow_target, dtype=torch.float32))
        m = transforms.matmul(
            lights_mod.light_projection_matrix(shadow_config), light_view)
    vp = transforms.matmul(camera.projection_matrix(), camera.view_matrix())
    return shadow, m, vp, torch.cat([
        f32(m), f32(camera.position), f32(light_anchor), f32(light.color),
        f32(lighting.ambient_intensity), f32(lighting.shininess),
        f32(config.clear_color), f32(config.shadow_bias),
        f32(config.shadow_factor),
    ])


def light_direction(lighting, device):
    """A directional light's direction, f32[3] on ``device``; else None."""
    light = lighting.light
    return (torch.as_tensor(light.direction, dtype=torch.float32).to(device)
            if isinstance(light, lights_mod.DirectionalLight) else None)


def light_pass(geom: PackedGeometry, light_m, config):
    """The shadow pass's TriangleSetup: ``geom`` projected by ``light_m``
    (the light's P @ V, f32[4,4] on the device), near-clipped and set up
    with no culling, valid for the shadow casters alone."""
    with annotate("mr/prep/shadow"):
        clip_l = transforms.transform_points(light_m, geom.world)
        clip_l2, _, parent_l = clip_near(clip_l.reshape(-1, 3, 4))
        size = config.shadow_map_size
        setup_l = setup_triangles(clip_l2, size, size,
                                  cull_backfaces=False,
                                  near_eps=config.near_eps)
        # Only shadow casters contribute (the Metal app encodes only
        # the cube into the shadow pass, mtl_engine.mm:785-787).
        return setup_l.replace(
            valid=setup_l.valid & geom.cast_shadow[
                parent_l.to(torch.int64)])


def prepare(scene, camera, lighting, config, shadow_config, displacement,
            shadow_target, device, main_geom, graphed) -> FramePrep:
    """A frame's prep on a resolved ``device``, uncopied: through its prep
    graph if ``graphed`` and the graph cache says so (a ``static``
    FramePrep), else op by op. ``main_geom``: as
    ``pipeline.prepare_frame``'s."""
    scene = scene.to(device)
    shadow, m, vp, uniforms = host_side(scene, camera, lighting, config,
                                        shadow_config, shadow_target)
    n_tris = (scene if main_geom is None else main_geom).num_triangles
    prep = None
    if graphed:
        prep = _graphed_prep(scene, displacement, vp, m, uniforms, shadow,
                             config, device, main_geom, n_tris)
    if prep is None:
        prep = _prep_device(
            scene, displacement, vp.to(device), m.to(device) if shadow
            else None, uniforms.to(device), shadow, config, main_geom,
            torch.tensor(n_tris, dtype=torch.int32, device=device))
    return dataclasses.replace(
        prep, light_dir=light_direction(lighting, device),
        textures=scene.textures, fused=fused_ok(scene, lighting, config))


def _prep_device(scene, displacement, vp, light_m, uniforms, shadow, config,
                 main_geom, n_tris) -> FramePrep:
    """The prep's device work: bake, both passes' clipping, setup and
    binning, and the stats. ``displacement``: a number or an f32[] on the
    device; ``vp``, ``light_m``: the camera's and the light's P @ V,
    f32[4,4] on the device (``light_m`` None without a shadow pass);
    ``uniforms`` f32[FU_LEN] and ``n_tris`` (the ``num_triangles`` stat)
    on the device. It neither syncs nor uploads, so a prep graph captures
    it whole. Returns the FramePrep without ``light_dir``, ``textures`` and
    ``fused``."""
    with annotate("mr/prep/bake"):
        geom_full = bake(scene, displacement)
    geom = geom_full if main_geom is None else main_geom
    stats = {"num_triangles": n_tris}

    shadow_bins = None
    if shadow:
        setup_l = light_pass(geom_full, light_m, config)
        size = config.shadow_map_size
        with annotate("mr/prep/shadow_bin"):
            shadow_bins = bin_triangles(
                setup_l, build_tri_fields(setup_l), size, size,
                config.shadow_tile_w, config.shadow_tile_h,
                span_cap=SHADOW_SPAN_CAP, big_capacity=config.big_capacity)
        stats["shadow_big_dropped"] = shadow_bins.num_big_dropped

    with annotate("mr/prep/main"):
        # The kernel on the card (the chain, its twin, elsewhere).
        front = setup_cuda.main_pass_tables(geom, vp, config)
        stats.update(front.stats)
    with annotate("mr/prep/main_bin"):
        main_bins = bin_triangles(
            front, front.vis, config.width, config.height,
            config.tile_w, config.tile_h, span_cap=config.span_cap,
            big_capacity=config.big_capacity, attr_fields=front.attr)
    stats["big_dropped"] = main_bins.num_big_dropped
    return FramePrep(shadow_bins, main_bins, uniforms, None, (), False,
                     stats)


def tables(prep: FramePrep):
    """The device tensors of a prep that its kernels and stats read: both
    passes' bins (``TileBins.TABLES``), the uniforms, the stats."""
    out = []
    for bins in (prep.shadow_bins, prep.main_bins):
        if bins is not None:
            out += [getattr(bins, k) for k in TileBins.TABLES
                    if getattr(bins, k) is not None]
    return out + [prep.uniforms, *prep.stats.values()]


def with_tables(prep: FramePrep, tensors) -> FramePrep:
    """``prep`` reading ``tensors`` (in ``tables``' order), no graph's."""
    it = iter(tensors)

    def bins_of(bins):
        return None if bins is None else dataclasses.replace(bins, **{
            k: next(it) for k in TileBins.TABLES
            if getattr(bins, k) is not None})
    shadow_bins = bins_of(prep.shadow_bins)
    main_bins = bins_of(prep.main_bins)
    uniforms = next(it)
    return dataclasses.replace(
        prep, shadow_bins=shadow_bins, main_bins=main_bins,
        uniforms=uniforms, stats={k: next(it) for k in prep.stats},
        static=False)


def copy_words(dst, src):
    """Copy every tensor of ``src`` into its ``dst`` bit for bit, in one
    launch on the card: both read as int32 words (a prep's tables all have
    4- or 8-byte elements)."""
    torch._foreach_copy_([d.reshape(-1).view(torch.int32) for d in dst],
                         [s.reshape(-1).view(torch.int32) for s in src])


def copy_tables(prep: FramePrep) -> FramePrep:
    """``prep`` reading a copy of its bins, uniforms and stats (one launch
    on the card), which no replay rewrites."""
    src = tables(prep)
    copies = [torch.empty_like(t) for t in src]
    copy_words(copies, src)
    return with_tables(prep, copies)


# The prep graph. Every shape in ``_prep_device`` follows from the scene's
# triangle counts, the config and the tile grid, and no op in it syncs with
# the host, so on the card it is captured once per shape as a CUDA graph
# and replayed: one graph launch in place of ~930 kernel launches a frame.
# The graph reads static inputs that each frame fills: the scene's tensors
# by one device copy, and the displacement, both P @ V products (formed on
# the host as the op-by-op prep forms them) and the uniforms by one upload
# from pinned memory. Its outputs are the same tensors at every replay.

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
    return (str(torch.device(device)), instances, wants_shadow(scene),
            tuple(getattr(config, f) for f in _PREP_CONFIG_FIELDS), geom)


def geometry_tensors(scene: Scene, main_geom):
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


def with_geometry(scene: Scene, main_geom, tensors):
    """(``scene`` without its textures, ``main_geom``) reading ``tensors``
    (in ``geometry_tensors``' order)."""
    instances = []
    for k, inst in enumerate(scene.instances):
        pos, uvs, nrm, model, color = tensors[5 * k:5 * k + 5]
        instances.append(dataclasses.replace(
            inst, mesh=Mesh(pos, uvs, nrm), model_matrix=model,
            material=dataclasses.replace(inst.material, color=color)))
    rest = tensors[5 * len(instances):]
    return (Scene(instances=tuple(instances)),
            PackedGeometry(*rest) if main_geom is not None else None)


def frame_upload(displacement, vp, light_m, uniforms):
    """A frame's one upload, f32[_UP_LEN] on the host: the displacement
    (taken as f32, as ``bake`` takes it), the camera's and the light's
    P @ V, the uniforms."""
    return torch.cat([torch.as_tensor(displacement, dtype=torch.float32)
                      .reshape(1).cpu(), vp.reshape(-1), light_m.reshape(-1),
                      uniforms])


def graph_body(scene, main_geom, upload, shadow, config, n_tris):
    """``_prep_device`` as a prep graph runs it: on ``scene`` and
    ``main_geom`` reading the static geometry and on the static ``upload``
    (``frame_upload``'s layout, on the device)."""
    return dataclasses.replace(_prep_device(
        scene, upload[_UP_DISP], upload[_UP_VP:_UP_LIGHT].view(4, 4),
        upload[_UP_LIGHT:_UP_UNIFORMS].view(4, 4) if shadow else None,
        upload[_UP_UNIFORMS:], shadow, config, main_geom, n_tris),
        static=True)


class PrepGraph:
    """One prep captured as a CUDA graph: its static inputs, the graph and
    the ``FramePrep`` that every replay rewrites."""

    def __init__(self, scene, shadow, config, device, main_geom, n_tris):
        self.device, self.shadow, self.config = device, shadow, config
        self.geometry = [torch.empty_like(t)
                         for t in geometry_tensors(scene, main_geom)]
        self.scene, self.main_geom = with_geometry(scene, main_geom,
                                                   self.geometry)
        self.upload = torch.empty(_UP_LEN, dtype=torch.float32,
                                  device=device)
        self.n_tris = torch.tensor(n_tris, dtype=torch.int32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.prep = None

    def fill(self, geometry, frame):
        """Set the inputs: ``geometry`` (``geometry_tensors``) copied on
        the device, ``frame`` (``frame_upload``'s arguments) packed in
        pinned memory and sent up in one asynchronous copy (PyTorch's pinned
        memory cache keeps the block until the copy has run)."""
        torch._foreach_copy_(self.geometry, geometry)
        self.upload.copy_(frame_upload(*frame).pin_memory(),
                          non_blocking=True)

    def _run(self):
        return graph_body(self.scene, self.main_geom, self.upload,
                          self.shadow, self.config, self.n_tris)

    def capture(self):
        """Capture the prep on the filled inputs and replay it
        (``capture_graph``)."""
        self.prep = capture_graph(self.graph, self._run, self.device)


# The process's prep graphs: every renderer of a process shares them, so a
# stream's warm-up captures what its later frames replay.
PREP_GRAPH = GraphCache()


def _graphed_prep(scene, displacement, vp, light_m, uniforms, shadow,
                  config, device, main_geom, n_tris):
    """The frame's prep through its prep graph (a ``static`` FramePrep),
    captured first at the shape's second frame; None where the frame runs
    op by op (``GraphCache.due``)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = prep_graph_key(scene, config, device, main_geom)
    graph = PREP_GRAPH.get(key)
    if graph is None and not PREP_GRAPH.due(key):
        return None
    frame = (displacement, vp, light_m, uniforms)
    geometry = geometry_tensors(scene, main_geom)
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
