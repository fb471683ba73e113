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
vertex stage to binning, ``passes.prep``) runs as one CUDA graph per scene
shape, captured at its second frame and replayed at every later one.

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

import contextlib
import contextvars
import dataclasses
import itertools

import torch

from ..config import RenderConfig, ShadowConfig
from ..raster import raster_cuda, reference_cpu, shade
from ..raster.setup_cuda import PassGeometry, prepare_main_pass
from ..scene import lights as lights_mod
from ..scene.scene import Scene, bake
from ..utils.profiling import annotate
from . import prep as frame_prep


def resolve_device(device) -> torch.device:
    """The render device; a CUDA device without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but "
                           "torch.cuda.is_available() is false")
    return device


def _check_supported(lighting, backend):
    """Any backend but "kernels" and "reference" raises ValueError, as in
    the JAX package."""
    if backend not in ("kernels", "reference"):
        raise ValueError(f"unknown rasterizer backend: {backend}")
    if not isinstance(lighting.light, (lights_mod.PointLight,
                                       lights_mod.DirectionalLight)):
        raise TypeError(f"unknown light type {type(lighting.light)!r}")


@dataclasses.dataclass(frozen=True)
class ReferencePrep:
    """The reference backend's frame, prepared on the device: the passes'
    triangle setups in place of bins."""

    shadow_setup: object     # TriangleSetup of the shadow pass, or None
    main_setup: object       # TriangleSetup of the main pass
    pass_geom: PassGeometry  # the main pass's per-vertex attributes
    uniforms: torch.Tensor   # f32[FU_LEN] shading uniforms (FU_* layout)
    light_dir: torch.Tensor  # f32[3] a directional light's direction, or None
    textures: tuple          # the scene's mip chains on the device
    stats: dict              # prep-side stats (0-d tensors)


def _prepare_reference(scene, camera, lighting, config, shadow_config,
                       displacement, shadow_target, device, main_geom):
    """The reference backend's prep on a resolved ``device``: the kernels'
    host side, bake and light pass, the main pass's setup, no binning (its
    ``big_dropped`` stats are zero)."""
    scene = scene.to(device)
    shadow, m, vp, uniforms = frame_prep.host_side(
        scene, camera, lighting, config, shadow_config, shadow_target)
    with annotate("mr/prep/bake"):
        geom_full = bake(scene, displacement)
    geom = geom_full if main_geom is None else main_geom
    zero = torch.zeros((), dtype=torch.int32, device=device)
    stats = {"num_triangles": torch.tensor(geom.num_triangles,
                                           dtype=torch.int32, device=device)}
    shadow_setup = None
    if shadow:
        shadow_setup = frame_prep.light_pass(geom_full, m.to(device), config)
        stats["shadow_big_dropped"] = zero
    with annotate("mr/prep/main"):
        setup, pg, main_stats = prepare_main_pass(geom, vp.to(device), config)
        stats.update(main_stats)
    stats["big_dropped"] = zero
    return ReferencePrep(shadow_setup, setup, pg, uniforms.to(device),
                         frame_prep.light_direction(lighting, device),
                         scene.textures, stats)


def prepare_frame(scene: Scene, camera, lighting,
                  config: RenderConfig = RenderConfig(),
                  shadow_config: ShadowConfig = ShadowConfig(),
                  displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                  backend="kernels", device="cuda",
                  main_geom=None):
    """The host-side part of a frame: vertex stage, clipping, triangle
    setup and binning of both passes, and the uniforms: a ``FramePrep``,
    or the reference backend's ``ReferencePrep`` (no bins). No kernel runs.

    ``main_geom`` (a ``PackedGeometry`` on ``device``, e.g. a band's pruned
    soup from ``parallel.sharding.prune_to_band``) replaces the scene's
    geometry in the main pass only: the shadow pass always takes the whole
    scene, since a caster outside the camera's view still shadows it.

    On a CUDA device with the kernels backend the prep's device work is a
    CUDA graph (``passes.prep``) from the second frame of its shape
    (``prep.prep_graph_key``) on: captured then, and replayed for every
    later one, with the frame's displacement, matrices and uniforms sent up
    in one upload and its geometry in one device copy. The tables returned
    are then a copy of the graph's outputs (one launch), the caller's to
    keep. Elsewhere (the CPU, the reference backend, a shape's first frame)
    the prep runs op by op, with the same results."""
    with annotate("mr/prep"):
        device = resolve_device(device)
        _check_supported(lighting, backend)
        if backend == "reference":
            return _prepare_reference(scene, camera, lighting, config,
                                      shadow_config, displacement,
                                      shadow_target, device, main_geom)
        prep = frame_prep.prepare(scene, camera, lighting, config,
                                  shadow_config, displacement, shadow_target,
                                  device, main_geom,
                                  graphed=device.type == "cuda")
        if prep.static and not _HAND_OVER.get():
            prep = frame_prep.copy_tables(prep)
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


def _shadow_pass(shadow_bins, config, stats):
    """K1 on one frame's shadow bins, or K4 on a batch's, depth alone (no
    winner plane, as the JAX ``rasterize_depth_batch`` returns): the shadow
    map f32[S, S] or f32[F, S, S] (None without shadow bins)."""
    if shadow_bins is None:
        return None
    size = config.shadow_map_size
    with annotate("mr/raster"):
        depth, _ = (raster_cuda.raster_depth_batch
                    if raster_cuda.is_batch(shadow_bins)
                    else raster_cuda.raster_depth)(
            shadow_bins, size, size, ((0.5, 0.5),), clear_depth=1.0,
            with_winner=False)
        shadow_map = depth[..., 0, :, :]     # the one sample's plane
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


def _render_reference(prep: ReferencePrep, config: RenderConfig):
    """The reference backend's passes and shading of one prepared frame:
    (rgba, stats). No kernel runs. The main pass is brute-force visibility
    anchored at the main-pass tiles (so z-fighting samples resolve as the
    kernels resolve them) and the per-sample G-buffer."""
    stats = dict(prep.stats)
    shadow_map = None
    if prep.shadow_setup is not None:
        size = config.shadow_map_size
        shadow_map = reference_cpu.rasterize_depth_brute_force(
            prep.shadow_setup, size, size,
            anchor=(config.shadow_tile_w, config.shadow_tile_h))
        stats["shadow_min_depth"] = torch.amin(shadow_map)
    samples, pg = tuple(config.sample_positions), prep.pass_geom
    depth, winner = reference_cpu.rasterize_brute_force(
        prep.main_setup, config.width, config.height, samples,
        anchor=(config.tile_w, config.tile_h))
    gbuf = reference_cpu.interpolate_gbuffer(
        prep.main_setup, winner, config.width, config.height, samples,
        pg.vattrs, pg.mat_kind, pg.mat_color, pg.tex_id, depth,
        normal_map_id=pg.normal_map_id)
    stats["covered_fraction"] = torch.mean(gbuf.covered.to(torch.float32))
    return _split_shade(shade.channels_from_gbuffer(gbuf), prep.uniforms,
                        shadow_map, prep.textures, prep.light_dir, config,
                        tiled_sampler=False), stats


def render_prepared(prep, config: RenderConfig):
    """Render a ``FramePrep`` or ``ReferencePrep`` you hold: the kernels
    (or the reference backend's passes) and shading of one prepared frame,
    (rgba, stats)."""
    if isinstance(prep, ReferencePrep):
        return _render_reference(prep, config)
    stats = dict(prep.stats)
    if prep.static:
        # The caller keeps the stats: copies, which no replay rewrites.
        copies = [torch.empty_like(v) for v in stats.values()]
        frame_prep.copy_words(copies, list(stats.values()))
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
    if frame_prep.attr_px(config):
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
        return render_prepared(prep, config)


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
    return (frame_prep.fused_ok(scene, lighting, config)
            and px_batch_eligible(scene, lighting, config, camera))


def px_batch_eligible(scene: Scene, lighting, config: RenderConfig,
                      camera=None) -> bool:
    """Can (scene, lighting, config) take ``render_frame_batch_px``?
    Per-pixel shading on 8x128 main-pass tiles (K5's layout) and, when
    ``camera`` is given, an orbit camera (frames differ by ``theta``)."""
    ok = frame_prep.attr_px(config)
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


def _check_batch_backend(backend):
    if backend != "kernels":
        raise ValueError("the batch kernels need backend='kernels'; "
                         "render_batch renders the reference frame by frame")


def stack_preps(preps, frames):
    """Stack a batch's ``frames`` preps for the batch kernels: a FramePrep
    whose bins (``raster_cuda.stack_bins``' layout), uniforms f32[F,
    FU_LEN] and stats carry a leading frame axis, and whose light_dir and
    textures are the first frame's. ``preps``, an iterable, is consumed
    here: each prep is copied into its frame's slot of the stacked tables
    (one launch on the card) as it comes, so that a graphed prep is kept
    before the next frame's replay rewrites it."""
    preps = iter(preps)
    first = next(preps)
    slots = [torch.empty((frames, *t.shape), dtype=t.dtype, device=t.device)
             for t in frame_prep.tables(first)]
    for f, prep in enumerate(itertools.chain([first], preps)):
        if (prep.shadow_bins is None) != (first.shadow_bins is None):
            raise ValueError("some frames of the batch have a shadow pass, "
                             "others not")
        tables = frame_prep.tables(prep)
        if f >= frames or [t.shape for t in tables] != [
                s.shape[1:] for s in slots]:
            raise ValueError(f"frame {f} of a batch of {frames}: its "
                             "tables do not fit the batch's")
        with annotate("mr/stack"):
            frame_prep.copy_words([s[f] for s in slots], tables)
    if f + 1 != frames:
        raise ValueError(f"{f + 1} preps for a batch of {frames} frames")
    stacked = frame_prep.with_tables(first, slots)

    def batch_bins(bins):
        return None if bins is None else dataclasses.replace(
            bins, big_n=bins.big_n.reshape(frames))
    return dataclasses.replace(
        stacked, shadow_bins=batch_bins(stacked.shadow_bins),
        main_bins=batch_bins(stacked.main_bins))


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
    batch = stack_preps(preps(), len(disps))
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
    batch = stack_preps(preps(), len(disps))
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
        rgba, st = render_prepared(prep, config)
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
