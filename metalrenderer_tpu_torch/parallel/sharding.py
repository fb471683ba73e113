"""Multi-device rendering (torch counterpart of
``metalrenderer_tpu.parallel.sharding``).

The reference is strictly single-GPU (one MTL::Device, mtl_engine.mm:122).
Here two axes scale out over the ranks of a ``Mesh``, as in the JAX
package:

  * frame-batch data parallelism (``render_frame_batch``): each rank renders
    its contiguous share of a batch of animated frames (the fused batch, K4
    + K6, where the scene takes it, else ``render_frame`` frame by frame),
    with no communication until the frames are gathered onto every rank;
  * a tile-sharded single frame (``render_tile_sharded``): the framebuffer
    splits into horizontal bands, one per rank. Each rank prunes the
    triangle list to the triangles that touch its band
    (``prune_to_band``), renders its band through ``render_frame`` with the
    pruned soup in the main pass and a ``BandedCamera`` whose projection
    maps the band onto the whole (band-sized) viewport, and the bands are
    gathered into the frame. ``render_band`` is one band's render, so a
    single device can also render every band in turn.

A ``Mesh`` is a group of ranks over ``torch.distributed`` that the caller
initializes: gloo for CPU ranks, NCCL with one card per rank (``cuda:<local
rank>``). A mesh of size 1 needs no process group.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch
import torch.distributed as dist

from ..config import RenderConfig, ShadowConfig
from ..passes import pipeline
from ..raster.geometry import clip_to_screen
from ..scene.scene import bake, project


@dataclasses.dataclass(frozen=True)
class BandedCamera:
    """Camera adapter whose projection maps horizontal band ``band`` of
    ``n_bands`` of the full frame onto the whole band-sized viewport.
    ``base`` may be any camera (OrbitCamera, PoseCamera)."""

    base: object = None
    band: int = 0            # band index in [0, n_bands)
    n_bands: int = 1

    @property
    def position(self):
        return self.base.position

    def view_matrix(self):
        return self.base.view_matrix()

    def projection_matrix(self):
        p = self.base.projection_matrix()
        # NDC y in [-1,1] maps to rows [0,H]. Band b covers NDC
        # [1 - 2(b+1)/n, 1 - 2b/n]. Affine remap to [-1, 1]:
        # y' = n*y - (n - 1 - 2b).
        nf = torch.tensor(float(self.n_bands), dtype=torch.float32)
        bf = torch.as_tensor(self.band, dtype=torch.float32)
        row = p[1] * nf + p[3] * -(nf - 1.0 - 2.0 * bf)
        p = p.clone()
        p[1] = row
        return p


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a render: ``size`` ranks, this process's
    ``rank``, their process ``group`` (None for a single rank) and the
    device this rank renders on."""

    size: int
    rank: int
    group: object
    device: torch.device
    axis: str = "batch"


def make_mesh(num_devices=None, axis="batch", device="cuda") -> Mesh:
    """The mesh of the default process group (initialized by the caller), or
    of this process alone when there is none. ``device="cuda"`` without an
    index takes card ``rank % device_count``. Raises ValueError when
    ``num_devices`` is not the group's size."""
    if dist.is_available() and dist.is_initialized():
        size, rank, group = (dist.get_world_size(), dist.get_rank(),
                             dist.group.WORLD)
    else:
        size, rank, group = 1, 0, None
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}, but the process group "
                         f"has {size} ranks")
    device = pipeline.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(size=size, rank=rank, group=group, device=device, axis=axis)


def _gather(mesh: Mesh, t):
    """Every rank's ``t`` stacked in rank order, on every rank."""
    if mesh.group is None:
        return t[None]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return torch.stack(out)


def render_frame_batch(scene, camera, lighting, displacements, thetas,
                       mesh: Mesh, config: RenderConfig = RenderConfig(),
                       shadow_config: ShadowConfig = ShadowConfig(),
                       shadow_target=(0.0, 0.0, 0.0), backend="kernels"):
    """Render a batch of orbit-camera frames split over ``mesh``'s ranks.

    ``displacements``, ``thetas``: B values each (taken as f32), B divisible
    by the mesh size; rank r renders frames [r*B/n, (r+1)*B/n) on its
    device. Returns the framebuffers f32[B, H, W, 4] on every rank."""
    disps = torch.as_tensor(displacements, dtype=torch.float32).reshape(-1)
    thetas = torch.as_tensor(thetas, dtype=torch.float32).reshape(-1)
    b = disps.shape[0]
    if b % mesh.size or thetas.shape[0] != b:
        raise ValueError(f"{b} displacements and {thetas.shape[0]} thetas: "
                         f"need one each per frame, divisible by mesh size "
                         f"{mesh.size}")
    share = b // mesh.size
    lo = mesh.rank * share
    disps, thetas = disps[lo:lo + share], thetas[lo:lo + share]
    if backend == "kernels" and pipeline.fused_batch_eligible(
            scene, lighting, config, camera):
        # Two launches for the rank's frames: K4 (shadow maps) and K6.
        fb, _ = pipeline.render_frame_batch_fused(
            scene, camera, lighting, config, shadow_config, disps, thetas,
            shadow_target=shadow_target, backend=backend, device=mesh.device)
    else:
        fb = torch.stack([pipeline.render_frame(
            scene, dataclasses.replace(camera, theta=float(t)), lighting,
            config, shadow_config, float(d), shadow_target, backend,
            mesh.device)[0] for d, t in zip(disps, thetas)])
    return _gather(mesh, fb).reshape(b, config.height, config.width, 4)


def prune_to_band(geom, view, proj, width, height, band_index, band_h, cap,
                  margin=1.0):
    """Compact the triangle soup to the triangles that touch one band.

    Per-triangle screen rows come from the vertex projection and the
    viewport mapping of ``clip_to_screen``: a triangle rides into the band
    iff its [ymin - margin, ymax + margin] rows meet rows
    [band*band_h, (band+1)*band_h); the 1 px margin absorbs rounding
    differences from triangle setup. A triangle with a vertex at w <= eps
    cannot be bounded without clipping, so it enters every band.

    Compaction is a stable sort (in-band triangles first, in submission
    order, so the LessEqual tie-break stays exact) and a gather of the first
    ``cap`` ids. Slots past the in-band count carry out-of-band triangles,
    which cover no pixel of the band. Triangles beyond ``cap`` are dropped
    and counted.

    Returns (pruned PackedGeometry, n_in_band i32[], dropped i32[])."""
    clip = project(geom.world, view, proj).reshape(-1, 3, 4)
    screen, _, _, w_ok = clip_to_screen(clip, width, height)
    rows = screen[..., 1]
    ymin = torch.amin(rows, dim=-1) - margin
    ymax = torch.amax(rows, dim=-1) + margin
    y0 = band_index * band_h
    y1 = y0 + band_h
    in_band = ~w_ok | ((ymax >= y0) & (ymin < y1))

    t = in_band.shape[0]
    order = torch.sort((~in_band).to(torch.uint8), stable=True).indices
    ids = order[:cap]

    def tri_rows(x):
        return x.reshape(t, 3, -1)[ids].reshape(ids.shape[0] * 3, -1)

    pruned = dataclasses.replace(
        geom, world=tri_rows(geom.world), uvs=tri_rows(geom.uvs),
        normals=tri_rows(geom.normals), mat_kind=geom.mat_kind[ids],
        mat_color=geom.mat_color[ids], tex_id=geom.tex_id[ids],
        normal_map_id=geom.normal_map_id[ids],
        cast_shadow=geom.cast_shadow[ids])
    n_in = in_band.sum().to(torch.int32)
    dropped = torch.clamp_min(n_in - cap, 0)
    return pruned, n_in, dropped


def band_capacity(num_triangles, n_bands, slack=2.0, floor=64):
    """Static per-band triangle capacity: ~slack * T/n, clamped to T.
    Overflow beyond it is reported (and those triangles drop; a scene
    crowded into one band needs a larger slack)."""
    cap = max(floor, math.ceil(num_triangles * slack / n_bands))
    return min(num_triangles, cap)


def prepare_band(scene, camera, lighting, band, n_bands,
                 config: RenderConfig = RenderConfig(),
                 shadow_config: ShadowConfig = ShadowConfig(),
                 displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                 backend="kernels", band_slack=2.0, device="cuda"):
    """The prep of band ``band`` of ``n_bands``: the soup pruned to the
    band (in full-frame rows, from the base camera's projection), then
    ``pipeline.prepare_frame`` of a ``height/n_bands``-row frame with the
    banded camera and the pruned soup in the main pass. Returns (FramePrep,
    the band's RenderConfig, n_in_band, dropped). Raises ValueError unless
    ``n_bands`` divides the height."""
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by "
                         f"{n_bands} bands")
    band_h = config.height // n_bands
    cap = band_capacity(scene.num_triangles, n_bands, slack=band_slack)
    device = pipeline.resolve_device(device)
    scene = scene.to(device)
    pruned, n_in, dropped = prune_to_band(
        bake(scene, displacement), camera.view_matrix(),
        camera.projection_matrix(), config.width, config.height, band,
        band_h, cap)
    band_cfg = config.replace(height=band_h)
    prep = pipeline.prepare_frame(
        scene, BandedCamera(base=camera, band=band, n_bands=n_bands),
        lighting, band_cfg, shadow_config, displacement, shadow_target,
        backend, device, main_geom=pruned)
    return prep, band_cfg, n_in, dropped


def render_band(scene, camera, lighting, band, n_bands,
                config: RenderConfig = RenderConfig(),
                shadow_config: ShadowConfig = ShadowConfig(),
                displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                backend="kernels", band_slack=2.0, device="cuda"):
    """Rows [band*H/n, (band+1)*H/n) of the frame: (rgba f32[H/n, W, 4],
    n_in_band i32[], dropped i32[]). Arguments as ``prepare_band``."""
    prep, band_cfg, n_in, dropped = prepare_band(
        scene, camera, lighting, band, n_bands, config, shadow_config,
        displacement, shadow_target, backend, band_slack, device)
    fb, _ = pipeline.render_prepared(prep, band_cfg)
    return fb, n_in, dropped


def render_tile_sharded(scene, camera, lighting, mesh: Mesh,
                        config: RenderConfig = RenderConfig(),
                        shadow_config: ShadowConfig = ShadowConfig(),
                        displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                        backend="kernels", band_slack=2.0,
                        with_stats=False):
    """Render ONE frame with its rows split over ``mesh``'s ranks: rank r
    renders band r (``render_band``) and the bands are gathered.

    Returns f32[H, W, 4] on every rank; with ``with_stats=True`` (fb,
    stats) where stats carries per rank ``band_triangles`` (in-band
    counts, i32[n]), ``band_dropped`` (overflow beyond the static per-band
    capacity, i32[n]: nonzero means raise ``band_slack``) and
    ``band_capacity``. Without stats a drop warns (RuntimeWarning). Raises
    ValueError unless the mesh size divides the height."""
    n = mesh.size
    fb, n_in, dropped = render_band(
        scene, camera, lighting, mesh.rank, n, config, shadow_config,
        displacement, shadow_target, backend, band_slack, mesh.device)
    out = _gather(mesh, fb).reshape(config.height, config.width, 4)
    n_in = _gather(mesh, n_in.reshape(1)).reshape(n)
    dropped = _gather(mesh, dropped.reshape(1)).reshape(n)
    cap = band_capacity(scene.num_triangles, n, slack=band_slack)
    if with_stats:
        return out, {"band_triangles": n_in, "band_dropped": dropped,
                     "band_capacity": cap}
    total_dropped = int(dropped.sum())
    if total_dropped:
        warnings.warn(
            f"render_tile_sharded dropped {total_dropped} triangles beyond "
            f"the per-band capacity {cap}; raise band_slack (or call with "
            "with_stats=True to inspect per-rank band_dropped)",
            RuntimeWarning, stacklevel=2)
    return out
