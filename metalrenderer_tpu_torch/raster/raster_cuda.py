"""Hand-written CUDA raster kernels for Hopper, with their plain twins.

Four kernels (``csrc/raster.cu``), each behind a wrapper that launches it
on a CUDA tensor and hands a CPU tensor to its plain PyTorch twin, all
specializations of one Pallas band-kernel factory
(``metalrenderer_tpu/raster/raster_pallas.py``: ``_make_kernel``), and the
first three with a frame-batch wrapper that launches them once over F frames:

``raster_depth`` (K1) — the depth-only specialization (``with_attrs=False``,
launched by ``rasterize_tiles``): per-sample depth and winner, or depth
alone (``with_winner=False``, what the shadow pass asks for). The shadow
pass.

``render_fused`` (K2) — the fused-shade specialization (launched by
``raster_pallas.render_fused``): MSAA visibility, the first covered sample's
attributes, Blinn-Phong/emissive shading, the shadow-map test and the
coverage resolve. The fused main pass.

``raster_gbuffer`` (K3) — the per-pixel G-buffer specialization
(``with_attrs=True, attr_px=True``, launched by ``rasterize_tiles``): K2's
visibility and fragment selection, writing the raw attribute rows that
``channels_from_gout_px`` and ``shade.shade_channels`` consume. The split
path's main pass.

``raster_gbuffer_samples`` (K3s) — the per-sample G-buffer specialization
(``with_attrs=True, attr_px=False``, launched by ``rasterize_tiles``): the
same visibility, then every sample's own winner's raw attribute rows at
that sample's position and the sample's depth, f32[S,16,H,W], which
``channels_from_gout`` and ``shade.shade_channels`` consume. Supersampled
shading (``shading_per_pixel=False``) and main-pass tiles other than 8x128.
The JAX package has no batch form of it, and neither has the port.

``raster_depth_batch`` (K4), ``raster_gbuffer_batch`` (K5) and
``render_fused_batch`` (K6) replace the frame-folded Pallas launches
``rasterize_depth_batch``, ``rasterize_tiles_batch`` and
``render_fused_batch``: the kernels' grid gains a frame axis over
``stack_bins`` of per-frame ``TileBins`` (the same tables with a leading
frame axis, the counterpart of ``raster_pallas._flatten_bins``), and every
frame of a batch is bit-equal to the per-frame launch on the same bins.
Their twins run the per-frame twins frame by frame.

What the kernels compute (and the twins, in the same operation order):

* Visibility is order-free. The Pallas kernel's binned walk (``zmin <=
  zbuf`` across chunks, max tid within a chunk) and its big-list walk
  (``z < zb or (z == zb and tid > wb)``) together keep, per sample, the
  lexicographic minimum of ``(z, -tid)`` over the candidates: triangles of
  the sample's tile list or of the live big list (behind the big list's
  AABB gate) that are valid, cover the sample (top-left rule) and have
  ``0 <= z <= 1``. Buffers start at ``(clear_depth, -1)``. So a thread may
  test its candidates in any order with ``take = ok and (z < zb or (z == zb
  and tid > wb))``, with no chunks and no separate big-list pass.
* Plane evaluation is anchored on the binning tile: ``c' = (c + a*ox) +
  b*oy`` with ``(ox, oy)`` the tile corner, then ``(a*xr + b*yr) + c'`` with
  ``(xr, yr)`` the tile-relative sample position — the Pallas kernel's
  rounding (``raster_pallas.py:225,240,526-527``). The anchor is the
  binning tile (64x128 in the shadow pass, 8x128 in the main pass),
  independent of the CUDA block shape. No FMA contraction anywhere
  (``-fmad=false``; eager torch ops round every step).
* The fragment stage takes, per pixel, the first sample (in sample order)
  whose winner is >= 0 and interpolates that winner's 15 attribute/w
  groups there: its edge values at the sample, anchored on the pixel and
  at least 0 (the walk found the sample inside), normalized by their sum,
  weight the three vertices' value/w (``_weights``: ``(l0*v0 + l1*v1) +
  l2*v2``, the reference's barycentrics). Each weight lies in [0, 1], so a
  value stays within its vertices' values on a sliver triangle too; the
  JAX kernels' planes of value/w at the absolute position, ``(a*sx + b*sy)
  + c``, cancel there (ROADMAP C13) and agree elsewhere to rounding. K3 stores
  them (zeros for an uncovered pixel) with the covered-sample count in row
  ``ROW_DEPTH``. K2 shades them with the ``1/sqrt`` Blinn-Phong form, tests
  the shadow map with an exact REPEAT bilinear lookup over the whole map
  (``sampling.sample_bilinear`` semantics; the Pallas kernel's DMA windows
  and its "lit" fallback outside them are not reproduced — ROADMAP C1) and
  blends with the clear color by the covered fraction. K3s interpolates,
  for every covered sample, its winner's 15 groups at that sample, once:
  the Pallas kernel rewrites them whenever a chunk's triangle takes the
  sample (``where(take8, val, old)``), which leaves the final winner's
  values, the same thing.

On the H100 K3s writes 64 bytes per sample (531 MB at 1920x1080x4), which
bound it; a thread per pixel walks its tile's candidate list serially
(``csrc/raster.cu`` header). K1, K2, K3 and their batch forms K4, K5, K6
share one tile walk, one block per binning tile and frame: the block gates
the tile's candidates once, stages them in shared memory
``FUSED_STAGING_CHUNK`` at a time with their planes anchored on the tile,
and every warp tests them on its pixels by broadcast, skipping a candidate
where a bound on its rounded edge values shows that no sample of the
warp's pixels can be inside (a skip that changes no result); they take any
tile shape. Only the fragment stage differs: K1 stores the depth (and the
winner if asked: 4 or 8 bytes a sample, its byte bound), K2 shades, K3
stores the 16 gout rows (64 bytes a pixel, which bound it), each store
coalesced across the warp. K1 and K4 may split a tile's passes over
several blocks (``_depth_parts``): the shadow pass's 1024^2 map has only
128 tiles of 64x128.

K2, K3, K5 and K6 also split a tile's candidates over blocks, so that no
long list is walked by one block alone (a UV sphere's pole tile holds
8,750 candidates at 3840x2160). A tile whose list and live big list hold
more than ``TILE_SPLIT_ABOVE`` entries becomes items of
``TILE_SPLIT_SLICE`` (L) in staging order; a small kernel builds the item
list on the device, and worker blocks behind the one-block-a-tile grid
walk one item each over every sample of the tile. Each item keeps its samples' winners from
``(clear_depth, -1)``; since visibility is order-free, the tile's winner
is their lexicographic minimum of ``(z, -tid)``, which the items merge
with a 64-bit atomic maximum of a key that orders as that minimum and
keeps the winner's own depth bits. The tile's last item runs the fragment
stage on the merged winners. A shorter tile walks as before, in one block
with no scratch and no atomic. The bounds of a launch come from the
bins' shapes alone (``split_plan``); no list length reaches the host. The
twin has the same split as an option (``split``, ``merge_order``), held
bit-equal to its default walk by the CPU tests; the kernels are held
against the default walk.

The twins work on pieces of tile rows at a time, so they run at 1080p MSAA4
on the card as well as on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..scene.materials import BLINN_PHONG_SHADOW, EMISSIVE
from . import _build, sample_cuda, shade
from .binning import (ATTR_GROUPS_PADDED, GOUT_ROWS, ROW_COLOR, ROW_DEPTH,
                      ROW_INVW, ROW_MATKIND, ROW_NMID, ROW_NORMAL, ROW_TEXID,
                      ROW_UV, ROW_WORLD, TileBins)

# Fused-shade uniform vector layout (f32[FU_LEN]), as in raster_pallas.py.
FU_M = 0        # 16: light_proj @ light_view, row-major (zeros w/o shadow)
FU_CAM = 16     # 3: camera position
FU_LPOS = 19    # 3: light position
FU_LCOL = 22    # 3: light color
FU_AMB = 25     # ambient intensity
FU_SHIN = 26    # shininess
FU_CLEAR = 27   # 4: clear color RGBA
FU_BIAS = 31    # shadow bias
FU_FACTOR = 32  # shadow factor
FU_LEN = 33

MAX_SAMPLES = 4
# Candidates the tile kernels (K2, K3, K5, K6) stage in shared memory per
# pass (csrc/raster.cu kChunk); a tile with more is walked chunk by chunk.
FUSED_STAGING_CHUNK = 256
# K2, K3, K5 and K6 split a tile whose list and live big list hold more
# than TILE_SPLIT_ABOVE entries into items of TILE_SPLIT_SLICE (L) that
# blocks walk apart, merged per sample (csrc/raster.cu, the split walk);
# both multiples of FUSED_STAGING_CHUNK. Measured on the H100 (PERF.md):
# slices of one chunk finish the long tiles soonest; the threshold of two
# bounds the merge scratch (split_plan) where a big list nears its cap.
TILE_SPLIT_SLICE = 256
TILE_SPLIT_ABOVE = 512
# Samples evaluated per step of a twin (bounds its temporaries).
_PLAIN_PIECE_SAMPLES = 1 << 21

# Launch counts of the kernels; each wrapper adds one per launch.
LAUNCHES = {"raster_depth": 0, "render_fused": 0, "raster_gbuffer": 0,
            "raster_gbuffer_samples": 0, "raster_depth_batch": 0, "render_fused_batch": 0,
            "raster_gbuffer_batch": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_batch(bins: TileBins) -> bool:
    """Does ``bins`` hold a frame batch (``stack_bins``' leading frame axis)?"""
    return bins.vis.dim() == 3


def frame_bins(bins: TileBins, f) -> TileBins:
    """Frame ``f``'s bins (views) of a ``stack_bins`` batch."""
    # big_n stays i32[1], as a frame's own.
    return dataclasses.replace(bins, **{
        k: None if t is None else t[f:f + 1] if k == "big_n" else t[f]
        for k in TileBins.TABLES for t in [getattr(bins, k)]})


def stack_bins(frames) -> TileBins:
    """Stack per-frame ``TileBins`` on a leading frame axis: vis f32[F,T,17],
    attr f32[F,T,48] or None, tile_offsets i32[F,NT+1] into the frame's own
    tile_tris i32[F,L], big_ids i32[F,cap], big_aabb i32[F,cap,4], big_n and
    num_big_dropped i32[F]. Tids and CSR pointers stay frame-local. Raises
    ValueError unless every frame has the same tile grid, the same table
    shapes and dtypes, and attribute tables in all frames or in none."""
    frames = list(frames)
    if not frames:
        raise ValueError("stack_bins: no frames")
    first = frames[0]
    grid = (first.tile_w, first.tile_h, first.ntx, first.nty)
    for b in frames[1:]:
        if (b.tile_w, b.tile_h, b.ntx, b.nty) != grid:
            raise ValueError("stack_bins: frames binned on different tile "
                             "grids")
        for k in TileBins.TABLES:
            x, y = getattr(first, k), getattr(b, k)
            if (x is None) != (y is None):
                raise ValueError(f"stack_bins: {k} present in some frames "
                                 "only")
            if x is not None and (x.shape != y.shape or x.dtype != y.dtype
                                  or x.device != y.device):
                raise ValueError(f"stack_bins: {k} differs between frames: "
                                 f"{tuple(x.shape)} {x.dtype} {x.device} vs "
                                 f"{tuple(y.shape)} {y.dtype} {y.device}")
    # big_n is i32[1] a frame: its frames concatenate to i32[F].
    return dataclasses.replace(first, **{
        k: None if getattr(first, k) is None
        else (torch.cat if k == "big_n" else torch.stack)(
            [getattr(b, k) for b in frames]) for k in TileBins.TABLES})


# --------------------------------------------------------------------------
# Plain twins
# --------------------------------------------------------------------------

def _tile_pixel_grid(bins: TileBins, sample_offsets, device):
    """Tile-relative sample coordinates xr, yr: f32[S, P] (P = tile pixels)."""
    p = torch.arange(bins.tile_h * bins.tile_w, device=device)
    offs = torch.tensor(sample_offsets, dtype=torch.float32, device=device)
    xr = (p % bins.tile_w).to(torch.float32)[None, :] + offs[:, 0:1]
    yr = (p // bins.tile_w).to(torch.float32)[None, :] + offs[:, 1:2]
    return xr, yr


def _staging_order(bins: TileBins, tiles):
    """Each tile's candidates in the order the kernels stage them: its list,
    then the live big list, -1 where an entry fails the big list's AABB gate
    or past the tile's entries. i64[n, max list + live big list]."""
    dev = tiles.device
    off = bins.tile_offsets.to(torch.int64)
    beg = off[tiles]
    cnt = off[tiles + 1] - beg
    lidx = torch.arange(int(cnt.max()), device=dev)[None, :]
    in_list = lidx < cnt[:, None]
    pos = torch.where(in_list, beg[:, None] + lidx, torch.zeros_like(lidx))
    cand_list = torch.where(in_list, bins.tile_tris.to(torch.int64)[pos], -1)

    nb = int(bins.big_n[0])
    bb = bins.big_aabb[:nb].to(torch.int64)                 # [nb, 4]
    tx = tiles % bins.ntx
    y0 = (tiles // bins.ntx) * bins.tile_h
    ov = (bb[None, :, 1] < (y0 + bins.tile_h)[:, None]) & \
        (bb[None, :, 3] > y0[:, None])
    sx0 = torch.clamp(torch.div(bb[:, 0], bins.tile_w, rounding_mode="floor"),
                      0, bins.ntx - 1)
    sx1 = torch.clamp(torch.div(bb[:, 2] - 1, bins.tile_w,
                                rounding_mode="floor"), 0, bins.ntx - 1)
    gate = ov & (tx[:, None] >= sx0[None, :]) & (tx[:, None] <= sx1[None, :])
    cand_big = torch.where(gate, bins.big_ids[:nb].to(torch.int64)[None, :], -1)
    # A tile's big entries follow its own list: staging index n_list + k.
    cand = torch.cat([cand_list, torch.full_like(cand_big, -1)], dim=1)
    col = cnt[:, None] + torch.arange(nb, device=dev)[None, :]
    return cand.scatter(1, col, cand_big)


def _candidates(bins: TileBins, tiles):
    """Candidate tids per tile: its list plus the AABB-gated live big list,
    valid tids first, -1 padding. i64[n, L]."""
    cand = torch.sort(_staging_order(bins, tiles), dim=1,
                      descending=True).values
    return cand[:, :int((cand >= 0).sum(dim=1).max())]


def _take(z, tid, zb, wb):
    """take: (z, tid) wins over (zb, wb), the lexicographic order of
    (z, -tid); ``z`` where a sample is not covered must not win."""
    return (z < zb) | ((z == zb) & (tid > wb))


def _walk(bins: TileBins, cand, ox, oy, xr, yr, zb, wb):
    """Test candidates ``cand`` [n, l] (-1: none) on the tiles' samples,
    updating per-sample (zb, wb) [n, S, P] with take."""
    for l in range(cand.shape[1]):
        tid = cand[:, l]
        present = tid >= 0
        f = bins.vis[torch.clamp_min(tid, 0)]                   # [n, 17]

        def plane(k):
            a, b, c = f[:, k], f[:, k + 1], f[:, k + 2]
            cof = (c + a * ox) + b * oy
            return (a[:, None, None] * xr + b[:, None, None] * yr) + \
                cof[:, None, None]

        ok = (present & (f[:, 15] > 0.0))[:, None, None]
        for e in range(3):
            ev = plane(3 * e)
            tl = (f[:, 12 + e] > 0.0)[:, None, None]
            ok = ok & ((ev > 0.0) | ((ev == 0.0) & tl))
        z = plane(9)
        ok = ok & (z >= 0.0) & (z <= 1.0)
        tid3 = tid[:, None, None]
        take = ok & _take(z, tid3, zb, wb)
        zb = torch.where(take, z, zb)
        wb = torch.where(take, tid3, wb)
    return zb, wb


def _visibility_plain(bins: TileBins, tiles, xr, yr, clear_depth,
                      split=None, merge_order=None):
    """Per-sample (depth, winner) for every pixel of ``tiles``: [n, S, P].

    With ``split`` (L candidates), the kernels' split walk: each tile's
    candidates in staging order (``_staging_order``) in slices of L, each
    slice walked from (clear_depth, -1), the slices' winners then reduced
    with take in ``merge_order(n_slices)`` (default: in order). Visibility
    is order-free, so this equals the walk of all candidates at once."""
    n = tiles.numel()
    S, P = xr.shape
    dev = xr.device
    ox = ((tiles % bins.ntx) * bins.tile_w).to(torch.float32)
    oy = ((tiles // bins.ntx) * bins.tile_h).to(torch.float32)

    def clear():
        return (torch.full((n, S, P), clear_depth, dtype=torch.float32,
                           device=dev),
                torch.full((n, S, P), -1, dtype=torch.int64, device=dev))

    if split is None:
        return _walk(bins, _candidates(bins, tiles), ox, oy, xr, yr, *clear())
    cand = _staging_order(bins, tiles)
    starts = range(0, max(cand.shape[1], 1), split)
    order = range(len(starts)) if merge_order is None else \
        merge_order(len(starts))
    if sorted(order) != list(range(len(starts))):
        raise ValueError(f"merge_order: not a permutation of {len(starts)} "
                         "slices")
    parts = [_walk(bins, cand[:, k:k + split], ox, oy, xr, yr, *clear())
             for k in starts]
    zb, wb = clear()
    for k in order:
        z, tid = parts[k]
        take = _take(z, tid, zb, wb)
        zb = torch.where(take, z, zb)
        wb = torch.where(take, tid, wb)
    return zb, wb


def _tile_pieces(bins: TileBins, n_samples, device):
    """Tile ids in pieces of whole tile rows, ~_PLAIN_PIECE_SAMPLES each."""
    row = n_samples * bins.tile_h * bins.tile_w * bins.ntx
    per = max(1, _PLAIN_PIECE_SAMPLES // row) * bins.ntx
    return torch.split(torch.arange(bins.ntx * bins.nty, device=device), per)


def _place(x, bins: TileBins, tiles, out):
    """Write per-tile pixel rows x[n, ..., P] of whole tile rows into
    out[..., Hp, Wp]."""
    lead = x.shape[1:-1]
    rows = tiles.numel() // bins.ntx
    v = x.reshape(rows, bins.ntx, *lead, bins.tile_h, bins.tile_w)
    k = len(lead)
    perm = tuple(range(2, 2 + k)) + (0, 2 + k, 1, 3 + k)
    v = v.permute(*perm).reshape(*lead, rows * bins.tile_h,
                                 bins.ntx * bins.tile_w)
    y0 = int(tiles[0] // bins.ntx) * bins.tile_h
    out[..., y0:y0 + rows * bins.tile_h, :] = v


def raster_depth_plain(bins: TileBins, width, height, sample_offsets,
                       clear_depth=1.0, with_winner=True):
    """Plain PyTorch twin of the ``raster_depth`` kernel (same inputs, same
    arithmetic). Returns (depth f32[S,H,W], winner i32[S,H,W], or None
    without ``with_winner``)."""
    dev = bins.vis.device
    S = len(sample_offsets)
    xr, yr = _tile_pixel_grid(bins, sample_offsets, dev)
    hp, wp = bins.nty * bins.tile_h, bins.ntx * bins.tile_w
    depth = torch.empty((S, hp, wp), dtype=torch.float32, device=dev)
    winner = torch.empty((S, hp, wp), dtype=torch.int32, device=dev)
    for tiles in _tile_pieces(bins, S, dev):
        zb, wb = _visibility_plain(bins, tiles, xr, yr, clear_depth)
        _place(zb, bins, tiles, depth)
        _place(wb.to(torch.int32), bins, tiles, winner)
    return (depth[:, :height, :width].contiguous(),
            winner[:, :height, :width].contiguous() if with_winner else None)


def _weights(bins: TileBins, tid, px, py, ox, oy):
    """The kernels' ``sample_weights``: triangle ``tid``'s (i64, >= 0)
    vertex weights (l0, l1, l2) at offset (ox, oy) in pixel (px, py) (f32
    of whole pixels), all broadcast: its edge values there anchored on the
    pixel, ``(a*ox + b*oy) + ((c + a*px) + b*py)``, each at least 0,
    normalized by their sum. Each lies in [0, 1]."""
    f = bins.vis[tid]                                        # [..., 17]

    def edge(k):
        a, b, c = f[..., 3 * k], f[..., 3 * k + 1], f[..., 3 * k + 2]
        e = (a * ox + b * oy) + ((c + a * px) + b * py)
        return torch.where(e < 0.0, torch.zeros_like(e), e)

    e0, e1, e2 = edge(0), edge(1), edge(2)
    total = (e1 + e2) + e0
    r = 1.0 / torch.where(total > 0.0, total, torch.ones_like(total))
    return e1 * r, e2 * r, e0 * r


def _pixels(bins: TileBins, tiles, P):
    """The pixels of ``tiles``' P tile positions: (px, py) f32[n, P]."""
    p = torch.arange(P, device=tiles.device)
    px = (tiles % bins.ntx)[:, None] * bins.tile_w + (p % bins.tile_w)[None]
    py = (tiles // bins.ntx)[:, None] * bins.tile_h + (p // bins.tile_w)[None]
    return px.to(torch.float32), py.to(torch.float32)


def _first_covered(bins: TileBins, tiles, wb, sample_offsets):
    """Per pixel of ``tiles`` (wb: i64[n, S, P] winners): the covered-sample
    count [n, P], the weights of the first covered sample's winner there
    (``_weights``, each [n, P]) and its attribute row A [n, P, 48]
    (triangle 0's where no sample is covered)."""
    dev = wb.device
    n, S, P = wb.shape
    covered_s = wb >= 0
    cnt = covered_s.sum(dim=1)                               # [n, P]
    first = torch.argmax(covered_s.to(torch.int32), dim=1)   # first covered
    tid = torch.clamp_min(torch.gather(wb, 1, first[:, None]).squeeze(1), 0)
    offs = torch.tensor(sample_offsets, dtype=torch.float32, device=dev)
    px, py = _pixels(bins, tiles, P)
    lam = _weights(bins, tid, px, py, offs[first, 0], offs[first, 1])
    return cnt, lam, bins.attr[tid]


def _attr_at(A, k, lam):
    """Attribute group ``k`` of rows ``A`` (per-vertex value/w) at weights
    ``lam``: (l0*v0 + l1*v1) + l2*v2."""
    return (lam[0] * A[..., k] + lam[1] * A[..., ATTR_GROUPS_PADDED + k]) + \
        lam[2] * A[..., 2 * ATTR_GROUPS_PADDED + k]


def _shade_pixels(bins: TileBins, tiles, wb, sample_offsets, uniforms,
                  shadow_map):
    """Fragment stage of the fused kernel for the pixels of ``tiles``.
    wb: i64[n, S, P] winners. Returns (rgba f32[n, 4, P], covf f32[n, P])."""
    S = wb.shape[1]
    u = uniforms
    cnt, lam, A = _first_covered(bins, tiles, wb, sample_offsets)

    def g(k):
        return _attr_at(A, k, lam)

    invw = g(ROW_INVW)
    inv = 1.0 / torch.where(invw > 0.0, invw, torch.ones_like(invw))
    w = tuple(g(ROW_WORLD + i) * inv for i in range(3))
    nrm = tuple(g(ROW_NORMAL + i) * inv for i in range(3))
    base = tuple(g(ROW_COLOR + i) * inv for i in range(3))
    covered = cnt > 0
    kf = torch.floor(g(ROW_MATKIND) * inv + 0.5)
    emissive = covered & (kf == float(EMISSIVE))
    receives = covered & (kf == float(BLINN_PHONG_SHADOW))

    lit = shade._blinn_phong_soa(
        w, nrm, base, u[FU_CAM:FU_CAM + 3], u[FU_LPOS:FU_LPOS + 3],
        u[FU_LCOL:FU_LCOL + 3], u[FU_AMB], u[FU_SHIN])
    planes = [torch.where(emissive, base[c], lit[c]) for c in range(3)]
    planes.append(torch.ones_like(planes[0]))
    if shadow_map is not None:
        m = u[FU_M:FU_M + 16].reshape(4, 4)
        sf = shade._shadow_factor_soa(w, m, shadow_map, u[FU_BIAS],
                                      u[FU_FACTOR], receives,
                                      sample_cuda.sample_bilinear_plain)
        msk = torch.where(receives, sf, torch.ones_like(sf))
        planes = [c * msk for c in planes]
    covf = cnt.to(torch.float32) * (1.0 / S)
    clear = u[FU_CLEAR:FU_CLEAR + 4]
    rgba = torch.stack(
        [torch.where(covered, planes[c] * covf + clear[c] * (1.0 - covf),
                     clear[c].expand_as(covf)) for c in range(4)], dim=1)
    return rgba, covf


def render_fused_plain(bins: TileBins, uniforms, shadow_map, width, height,
                       sample_offsets, clear_depth=1.0, split=None,
                       merge_order=None):
    """Plain PyTorch twin of the ``render_fused`` kernel (same inputs, same
    arithmetic). Returns (rgba f32[H,W,4], covered_frac f32[H,W]).
    ``split``, ``merge_order``: the split walk (``_visibility_plain``)."""
    dev = bins.vis.device
    S = len(sample_offsets)
    xr, yr = _tile_pixel_grid(bins, sample_offsets, dev)
    hp, wp = bins.nty * bins.tile_h, bins.ntx * bins.tile_w
    rgba = torch.empty((4, hp, wp), dtype=torch.float32, device=dev)
    covf = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    for tiles in _tile_pieces(bins, S, dev):
        _, wb = _visibility_plain(bins, tiles, xr, yr, clear_depth, split,
                                  merge_order)
        c, f = _shade_pixels(bins, tiles, wb, sample_offsets, uniforms,
                             shadow_map)
        _place(c, bins, tiles, rgba)
        _place(f[:, None], bins, tiles, covf[None])
    return (rgba[:, :height, :width].permute(1, 2, 0).contiguous(),
            covf[:height, :width].contiguous())


def raster_gbuffer_plain(bins: TileBins, width, height, sample_offsets,
                         clear_depth=1.0, with_samples=False, split=None,
                         merge_order=None):
    """Plain PyTorch twin of the ``raster_gbuffer`` kernel (same inputs, same
    arithmetic). Returns (gout f32[16,H,W], depth f32[S,H,W] or None,
    winner i32[S,H,W] or None). ``split``, ``merge_order``: the split walk
    (``_visibility_plain``)."""
    dev = bins.vis.device
    S = len(sample_offsets)
    xr, yr = _tile_pixel_grid(bins, sample_offsets, dev)
    hp, wp = bins.nty * bins.tile_h, bins.ntx * bins.tile_w
    gout = torch.empty((GOUT_ROWS, hp, wp), dtype=torch.float32, device=dev)
    if with_samples:
        depth = torch.empty((S, hp, wp), dtype=torch.float32, device=dev)
        winner = torch.empty((S, hp, wp), dtype=torch.int32, device=dev)
    for tiles in _tile_pieces(bins, S, dev):
        zb, wb = _visibility_plain(bins, tiles, xr, yr, clear_depth, split,
                                   merge_order)
        if with_samples:
            _place(zb, bins, tiles, depth)
            _place(wb.to(torch.int32), bins, tiles, winner)
        cnt, lam, A = _first_covered(bins, tiles, wb, sample_offsets)
        covered = cnt > 0
        zero = torch.zeros_like(lam[0])
        rows = [torch.where(covered, _attr_at(A, k, lam), zero)
                for k in range(GOUT_ROWS - 1)]
        rows.append(cnt.to(torch.float32))
        _place(torch.stack(rows, dim=1), bins, tiles, gout)
    gout = gout[:, :height, :width].contiguous()
    if not with_samples:
        return gout, None, None
    return (gout, depth[:, :height, :width].contiguous(),
            winner[:, :height, :width].contiguous())


def raster_gbuffer_samples_plain(bins: TileBins, width, height,
                                 sample_offsets, clear_depth=1.0):
    """Plain PyTorch twin of the ``raster_gbuffer_samples`` kernel (same
    inputs, same arithmetic). Returns (gout f32[S,16,H,W], depth f32[S,H,W],
    winner i32[S,H,W])."""
    dev = bins.vis.device
    S = len(sample_offsets)
    xr, yr = _tile_pixel_grid(bins, sample_offsets, dev)
    hp, wp = bins.nty * bins.tile_h, bins.ntx * bins.tile_w
    gout = torch.empty((S, GOUT_ROWS, hp, wp), dtype=torch.float32,
                       device=dev)
    depth = torch.empty((S, hp, wp), dtype=torch.float32, device=dev)
    winner = torch.empty((S, hp, wp), dtype=torch.int32, device=dev)
    coef = bins.attr.T.contiguous()                          # [48, T]
    g = ATTR_GROUPS_PADDED
    offs = torch.tensor(sample_offsets, dtype=torch.float32, device=dev)
    for tiles in _tile_pieces(bins, S, dev):
        zb, wb = _visibility_plain(bins, tiles, xr, yr, clear_depth)
        _place(zb, bins, tiles, depth)
        _place(wb.to(torch.int32), bins, tiles, winner)
        covered = wb >= 0
        tid = torch.clamp_min(wb, 0)                         # [n, S, P]
        px, py = _pixels(bins, tiles, wb.shape[2])
        l0, l1, l2 = _weights(bins, tid, px[:, None], py[:, None],
                              offs[:, 0, None], offs[:, 1, None])
        zero = torch.zeros_like(zb)
        rows = [torch.where(covered, (l0 * coef[k][tid] + l1 * coef[g + k][tid])
                            + l2 * coef[2 * g + k][tid], zero)
                for k in range(GOUT_ROWS - 1)]
        rows.append(zb)
        _place(torch.stack(rows, dim=2), bins, tiles, gout)
    return (gout[..., :height, :width].contiguous(),
            depth[:, :height, :width].contiguous(),
            winner[:, :height, :width].contiguous())


def _frames(bins: TileBins):
    """The frame count of a ``stack_bins`` batch; ValueError otherwise."""
    if not is_batch(bins):
        raise ValueError("need a frame batch (stack_bins), got one frame's "
                         f"bins: vis {tuple(bins.vis.shape)}")
    return bins.vis.shape[0]


def raster_depth_batch_plain(bins: TileBins, width, height,
                             sample_offsets, clear_depth=1.0,
                             with_winner=True):
    """Plain twin of ``raster_depth_batch``: ``raster_depth_plain`` frame by
    frame. Returns (depth f32[F,S,H,W], winner i32[F,S,H,W], or None
    without ``with_winner``)."""
    outs = [raster_depth_plain(frame_bins(bins, f), width, height,
                               sample_offsets, clear_depth, with_winner)
            for f in range(_frames(bins))]
    return (torch.stack([d for d, _ in outs]),
            torch.stack([w for _, w in outs]) if with_winner else None)


def raster_gbuffer_batch_plain(bins: TileBins, width, height,
                               sample_offsets, clear_depth=1.0):
    """Plain twin of ``raster_gbuffer_batch``: ``raster_gbuffer_plain``
    frame by frame. Returns gout f32[F,16,H,W]."""
    return torch.stack([
        raster_gbuffer_plain(frame_bins(bins, f), width, height,
                             sample_offsets, clear_depth)[0]
        for f in range(_frames(bins))])


def render_fused_batch_plain(bins: TileBins, uniforms, shadow_maps, width,
                             height, sample_offsets, clear_depth=1.0):
    """Plain twin of ``render_fused_batch``: ``render_fused_plain`` frame by
    frame. Returns (rgba f32[F,H,W,4], covered_frac f32[F,H,W])."""
    outs = [render_fused_plain(
        frame_bins(bins, f), uniforms[f],
        None if shadow_maps is None else shadow_maps[f], width, height,
        sample_offsets, clear_depth) for f in range(_frames(bins))]
    return (torch.stack([c for c, _ in outs]),
            torch.stack([v for _, v in outs]))


def _channels(rows, covered):
    """Shading channels from raw gout rows (``rows[i]``: row i's planes):
    the value/w rows divided by the interpolated 1/w, ids rounded
    half-to-even (``jnp.rint``), -1 where not covered."""
    invw = rows[ROW_INVW]
    inv = 1.0 / torch.where(invw > 0.0, invw, torch.ones_like(invw))

    def row(i):
        return rows[i] * inv

    def ids(i):
        return torch.where(covered, torch.round(row(i)).to(torch.int32),
                           torch.full_like(invw, -1, dtype=torch.int32))

    return {
        "wx": row(ROW_WORLD), "wy": row(ROW_WORLD + 1),
        "wz": row(ROW_WORLD + 2),
        "nx": row(ROW_NORMAL), "ny": row(ROW_NORMAL + 1),
        "nz": row(ROW_NORMAL + 2),
        "u": row(ROW_UV), "v": row(ROW_UV + 1),
        "kind": ids(ROW_MATKIND), "texid": ids(ROW_TEXID),
        "nmid": ids(ROW_NMID),
        "cr": row(ROW_COLOR), "cg": row(ROW_COLOR + 1),
        "cb": row(ROW_COLOR + 2),
        "covered": covered,
    }


def channels_from_gout_px(gout, n_samples):
    """Per-pixel shading channels from a ``raster_gbuffer`` gout
    f32[16, ...] (``raster_pallas.channels_from_gout_px``): covered where
    ROW_DEPTH's covered-sample count is positive, and the covered fraction
    from that count."""
    cnt = gout[ROW_DEPTH]
    return dict(_channels(gout, cnt > 0.0), cov_frac=cnt * (1.0 / n_samples))


def channels_from_gout(gout, winner):
    """Per-sample shading channels, [S, H, W] planes, from a
    ``raster_gbuffer_samples`` gout f32[S,16,H,W] and its winners
    (``raster_pallas.channels_from_gout``): covered means the sample has a
    winner, and there is no covered fraction."""
    return _channels(gout.transpose(0, 1), winner >= 0)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# tables, tile_w, tile_h, ntx, frames, T, L, cap
_BINS_ARGS = [_P] * 6 + [_I] * 7
_SAMPLE_ARGS = [_I] + [_F] * (2 * MAX_SAMPLES) + [_F]   # n, offsets, clear
# threshold and item chunks, max items, max split tiles, workers; head,
# keys, done
_SPLIT_ARGS = [_I] * 5 + [_P] * 3


@functools.cache
def _lib():
    lib = _build.load_library()
    lib.mr_raster_depth.argtypes = (_BINS_ARGS + _SAMPLE_ARGS
                                    + [_I, _I, _I, _P, _P, _P])
    lib.mr_raster_depth.restype = _I
    lib.mr_render_fused.argtypes = (_BINS_ARGS + _SAMPLE_ARGS
                                    + [_P, _P, _P, _I, _I]
                                    + [_I, _I, _P, _P] + _SPLIT_ARGS + [_P])
    lib.mr_render_fused.restype = _I
    lib.mr_raster_gbuffer.argtypes = (_BINS_ARGS + _SAMPLE_ARGS
                                      + [_P, _I, _I, _P, _P, _P]
                                      + _SPLIT_ARGS + [_P])
    lib.mr_raster_gbuffer.restype = _I
    lib.mr_raster_gbuffer_samples.argtypes = (_BINS_ARGS + _SAMPLE_ARGS
                                              + [_P, _I, _I, _P, _P, _P, _P])
    lib.mr_raster_gbuffer_samples.restype = _I
    return lib


def _check_grid(bins: TileBins, width, height):
    if (bins.ntx, bins.nty) != (-(-width // bins.tile_w),
                                -(-height // bins.tile_h)):
        raise ValueError(f"bins cover {bins.ntx}x{bins.nty} tiles of "
                         f"{bins.tile_w}x{bins.tile_h}, not {width}x{height}")


_MAX_FRAMES = 65535     # gridDim.z


def _bins_args(bins: TileBins, device, lead):
    """The C arguments of one frame's bins (``lead`` ()) or of a batch's
    (``lead`` (F,)); the table shapes must carry ``lead``."""
    F = lead[0] if lead else 1
    if not 1 <= F <= _MAX_FRAMES:
        raise ValueError(f"1..{_MAX_FRAMES} frames supported, got {F}")
    T = bins.vis.shape[-2]
    L = bins.tile_tris.shape[-1]
    cap = bins.big_ids.shape[-1]
    check = _build.check
    check("vis", bins.vis, torch.float32, device, lead + (T, 17))
    check("tile_offsets", bins.tile_offsets, torch.int32, device,
          lead + (bins.ntx * bins.nty + 1,))
    check("tile_tris", bins.tile_tris, torch.int32, device, lead + (L,))
    check("big_ids", bins.big_ids, torch.int32, device, lead + (cap,))
    check("big_aabb", bins.big_aabb, torch.int32, device, lead + (cap, 4))
    check("big_n", bins.big_n, torch.int32, device, (F,))
    if bins.attr is not None:
        check("attr", bins.attr, torch.float32, device, lead + (T, 48))
    ptr = _build.ptr
    return [ptr(bins.vis), ptr(bins.tile_offsets), ptr(bins.tile_tris),
            ptr(bins.big_ids), ptr(bins.big_aabb), ptr(bins.big_n),
            bins.tile_w, bins.tile_h, bins.ntx, F, T, L, cap]


def _need_attr(bins):
    if bins.attr is None:
        raise ValueError("bins carry no attribute planes (bin_triangles("
                         "attr_fields=...))")


def _sample_args(sample_offsets, clear_depth):
    if not 1 <= len(sample_offsets) <= MAX_SAMPLES:
        raise ValueError(f"1..{MAX_SAMPLES} samples supported")
    flat = [0.0] * (2 * MAX_SAMPLES)
    for s, (x, y) in enumerate(sample_offsets):
        flat[2 * s], flat[2 * s + 1] = float(x), float(y)
    return [len(sample_offsets)] + flat + [float(clear_depth)]


# K1/K4 split every tile's passes over blockIdx.y until the grid holds at
# least this many blocks (about four times the 132 x 8 blocks an H100 holds
# at once), or every pass has a block of its own. Measured on the H100
# (PERF.md): one 1024^2 shadow map runs fastest at 8 parts (1,024 blocks),
# eight of them at 4 parts (4,096 blocks).
_DEPTH_GRID_BLOCKS = 4096


def _depth_parts(bins: TileBins, frames):
    """Blocks each tile's passes are split over in K1/K4 (gridDim.y). A
    pass is kTileWarps = 8 row segments of kSegW = 128 columns
    (``csrc/raster.cu`` walk_tile)."""
    segs = bins.tile_h * -(-bins.tile_w // 128)
    passes = -(-segs // 8)
    blocks = bins.ntx * bins.nty * frames
    parts = 1
    while parts < passes and blocks * parts < _DEPTH_GRID_BLOCKS:
        parts *= 2
    return min(parts, passes)


def _launch_depth(name, bins, width, height, sample_offsets, clear_depth,
                  lead, with_winner):
    device = bins.vis.device
    args = (_bins_args(bins, device, lead)
            + _sample_args(sample_offsets, clear_depth))
    shape = lead + (len(sample_offsets), height, width)
    depth = torch.empty(shape, dtype=torch.float32, device=device)
    winner = (torch.empty(shape, dtype=torch.int32, device=device)
              if with_winner else None)
    parts = _depth_parts(bins, lead[0] if lead else 1)
    err = _lib().mr_raster_depth(*args, width, height, parts,
                                 _build.ptr(depth), _build.ptr(winner),
                                 _build.stream(device))
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return depth, winner


def raster_depth(bins: TileBins, width, height, sample_offsets,
                 clear_depth=1.0, with_winner=True):
    """Depth-only raster (kernel K1). Returns (depth f32[S,H,W], winner
    i32[S,H,W]; -1 = no triangle); without ``with_winner`` no winner plane
    is written and None comes in its place. CPU tensors go to the plain
    twin; CUDA tensors launch the kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return raster_depth_plain(bins, width, height, sample_offsets,
                                  clear_depth, with_winner)
    return _launch_depth("raster_depth", bins, width, height, sample_offsets,
                         clear_depth, (), with_winner)


def raster_depth_batch(bins: TileBins, width, height, sample_offsets,
                       clear_depth=1.0, with_winner=True):
    """K1 over a ``stack_bins`` frame batch in one launch (kernel K4).
    Returns (depth f32[F,S,H,W], winner i32[F,S,H,W], or None without
    ``with_winner``). CPU tensors go to the plain twin; CUDA tensors launch
    the kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return raster_depth_batch_plain(bins, width, height, sample_offsets,
                                        clear_depth, with_winner)
    return _launch_depth("raster_depth_batch", bins, width, height,
                         sample_offsets, clear_depth, (_frames(bins),),
                         with_winner)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The bounds of a K2/K3/K5/K6 launch's split walk, from the bins'
    shapes alone (no list length leaves the device): a tile of more than
    ``above`` staging chunks is split into items of ``chunks``, at most
    ``items`` items and ``tiles`` split tiles over all frames, taken by
    ``workers`` worker blocks. None of them where no tile of such bins can
    be split."""

    above: int
    chunks: int
    items: int
    tiles: int
    workers: int


def split_plan(bins: TileBins, frames=1):
    """The ``SplitPlan`` of a launch on ``bins`` (``frames`` of them), or
    None. A tile is split when its list and its live big list hold more
    than A = TILE_SPLIT_ABOVE entries, into items of L = TILE_SPLIT_SLICE.
    A frame's lists hold at most Lc entries together (``tile_tris``'
    length) and its live big list at most cap (``big_ids``' length), so a
    split tile holds at least A + 1 - cap list entries: a frame has at most
    R = min(NT, Lc // (A + 1 - cap)) split tiles (NT where A < cap), whose
    ceil((list + big) / L) items number at most
    (Lc + R * (cap + L - 1)) // L."""
    A, L = TILE_SPLIT_ABOVE, TILE_SPLIT_SLICE
    for name, v in (("TILE_SPLIT_ABOVE", A), ("TILE_SPLIT_SLICE", L)):
        if v <= 0 or v % FUSED_STAGING_CHUNK:
            raise ValueError(f"{name} {v}: need a positive multiple of "
                             f"{FUSED_STAGING_CHUNK}")
    nt = bins.ntx * bins.nty
    lc = bins.tile_tris.shape[-1]
    cap = bins.big_ids.shape[-1]
    need = A + 1 - cap
    tiles = nt if need <= 0 else min(nt, lc // need)
    if tiles == 0:
        return None
    items = min((lc + tiles * (cap + L - 1)) // L,
                tiles * -(-(lc + cap) // L))
    return SplitPlan(above=A // FUSED_STAGING_CHUNK,
                     chunks=L // FUSED_STAGING_CHUNK, items=frames * items,
                     tiles=frames * tiles,
                     workers=min(frames * items, _split_workers(bins)))


# Split kernel blocks per SM of the card: they take items until none is
# left, beside the tile kernel's blocks.
_SPLIT_WORKERS_PER_SM = 1


def _split_workers(bins: TileBins):
    """Blocks of a split kernel on ``bins``' card (1 on the CPU)."""
    dev = bins.vis.device
    if dev.type != "cuda":
        return 1
    return _SPLIT_WORKERS_PER_SM * _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device())


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# The split walk's device scratch, per (device, stream): the merge keys
# (u64 per split tile, sample and tile pixel), the per-tile counts and the
# head's counters, all zero between launches (a tile's last item resets
# its own keys and count, each kernel's last block its counters), and the
# items after the counters, which every split launch writes anew.
# Allocated zeroed by the wrapper and grown when a launch's plan needs
# more; a launch allocates nothing.
_SPLIT_SCRATCH = {}
# The head's counters before its items (csrc/raster.cu kHeadInts), and
# where the last split launch leaves its item count (kHeadLastItems).
_HEAD_INTS = 8
_HEAD_LAST_ITEMS = 7


def _split_args(plan, bins: TileBins, n_samples, device, stream):
    """The C arguments of a launch's split plan (``_SPLIT_ARGS``)."""
    if plan is None:
        return [0, 0, 0, 0, 0, None, None, None]
    need = {"keys": plan.tiles * n_samples * bins.tile_w * bins.tile_h,
            "done": plan.tiles, "head": _HEAD_INTS + 4 * plan.items}
    key = (device, stream.value)
    have = _SPLIT_SCRATCH.setdefault(key, {})
    for k, n in need.items():
        if k not in have or have[k].numel() < n:
            have[k] = torch.zeros(n, dtype=torch.int64 if k == "keys"
                                  else torch.int32, device=device)
    return [plan.above, plan.chunks, plan.items, plan.tiles, plan.workers,
            _build.ptr(have["head"]), _build.ptr(have["keys"]),
            _build.ptr(have["done"])]


def split_stats(bins: TileBins, n_samples):
    """What the split walk does on ``bins`` (a frame or a ``stack_bins``
    batch), counted on the host from the lists (it synchronises; the
    wrappers never call it): split tiles, their items, the longest tile's
    items, the merge keys those tiles use and what the plan allocates, in
    bytes."""
    frames = _frames(bins) if is_batch(bins) else 1
    plan = split_plan(bins, frames)
    off = bins.tile_offsets.reshape(frames, -1).to(torch.int64)
    n = off[:, 1:] - off[:, :-1] + bins.big_n.reshape(frames, 1)
    chunks = -(-n // FUSED_STAGING_CHUNK)
    lc = TILE_SPLIT_SLICE // FUSED_STAGING_CHUNK
    items = torch.where(chunks > TILE_SPLIT_ABOVE // FUSED_STAGING_CHUNK,
                        -(-chunks // lc), 0)
    tile_bytes = n_samples * bins.tile_w * bins.tile_h * 8
    split = int((items > 0).sum())
    return {"split_tiles": split, "items": int(items.sum()),
            "max_items": int(items.max()), "merge_key_bytes":
            split * tile_bytes,
            "scratch_bytes": 0 if plan is None else
            plan.tiles * (tile_bytes + 4) + (_HEAD_INTS + 4 * plan.items) * 4}


def scheduled_items(device):
    """The item count the last split launch on ``device``'s current stream
    queued on the device (it synchronises), or None."""
    have = _SPLIT_SCRATCH.get((torch.device(device), _build.stream(
        device).value))
    return None if have is None else int(have["head"][_HEAD_LAST_ITEMS])


def _launch_gbuffer(name, bins, width, height, sample_offsets, clear_depth,
                    lead, with_samples=False):
    device = bins.vis.device
    _need_attr(bins)
    args = (_bins_args(bins, device, lead)
            + _sample_args(sample_offsets, clear_depth))
    if bins.attr.data_ptr() % 16:
        raise ValueError("attr: K3/K5 load its rows as float4, need a "
                         "16-byte aligned tensor")
    gout = torch.empty(lead + (GOUT_ROWS, height, width), dtype=torch.float32,
                       device=device)
    depth = winner = None
    if with_samples:
        shape = lead + (len(sample_offsets), height, width)
        depth = torch.empty(shape, dtype=torch.float32, device=device)
        winner = torch.empty(shape, dtype=torch.int32, device=device)
    stream = _build.stream(device)
    split = _split_args(split_plan(bins, lead[0] if lead else 1), bins,
                        len(sample_offsets), device, stream)
    err = _lib().mr_raster_gbuffer(
        *args, _build.ptr(bins.attr), width, height, _build.ptr(gout),
        _build.ptr(depth), _build.ptr(winner), *split, stream)
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return gout, depth, winner


def raster_gbuffer(bins: TileBins, width, height, sample_offsets,
                   clear_depth=1.0, with_samples=False):
    """Per-pixel G-buffer raster (kernel K3). Returns (gout f32[16,H,W]: the
    first covered sample's winner's raw value/w rows and, in ROW_DEPTH, the
    covered-sample count; and, if ``with_samples``, depth f32[S,H,W] and
    winner i32[S,H,W], else None twice). CPU tensors go to the plain twin;
    CUDA tensors launch the kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return raster_gbuffer_plain(bins, width, height, sample_offsets,
                                    clear_depth, with_samples)
    return _launch_gbuffer("raster_gbuffer", bins, width, height,
                           sample_offsets, clear_depth, (), with_samples)


def raster_gbuffer_samples(bins: TileBins, width, height, sample_offsets,
                           clear_depth=1.0):
    """Per-sample G-buffer raster (kernel K3s), on bins of any tile shape.
    Returns (gout f32[S,16,H,W]: every sample's winner's raw value/w rows at
    that sample's position, zeros where the sample is uncovered, and in
    ROW_DEPTH the sample's depth; depth f32[S,H,W]; winner i32[S,H,W], -1 =
    no triangle). CPU tensors go to the plain twin; CUDA tensors launch the
    kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    _need_attr(bins)
    if bins.vis.device.type == "cpu":
        return raster_gbuffer_samples_plain(bins, width, height,
                                            sample_offsets, clear_depth)
    device = bins.vis.device
    args = (_bins_args(bins, device, ())
            + _sample_args(sample_offsets, clear_depth))
    S = len(sample_offsets)
    gout = torch.empty((S, GOUT_ROWS, height, width), dtype=torch.float32,
                       device=device)
    depth = torch.empty((S, height, width), dtype=torch.float32,
                        device=device)
    winner = torch.empty((S, height, width), dtype=torch.int32,
                         device=device)
    err = _lib().mr_raster_gbuffer_samples(
        *args, _build.ptr(bins.attr), width, height, _build.ptr(gout),
        _build.ptr(depth), _build.ptr(winner), _build.stream(device))
    _build.raise_on(err, "raster_gbuffer_samples")
    LAUNCHES["raster_gbuffer_samples"] += 1
    return gout, depth, winner


def raster_gbuffer_batch(bins: TileBins, width, height, sample_offsets,
                         clear_depth=1.0):
    """K3 over a ``stack_bins`` frame batch in one launch (kernel K5).
    Returns gout f32[F,16,H,W]. CPU tensors go to the plain twin; CUDA
    tensors launch the kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return raster_gbuffer_batch_plain(bins, width, height,
                                          sample_offsets, clear_depth)
    return _launch_gbuffer("raster_gbuffer_batch", bins, width, height,
                           sample_offsets, clear_depth, (_frames(bins),))[0]


def _launch_fused(name, bins, uniforms, shadow_map, width, height,
                  sample_offsets, clear_depth, lead):
    device = bins.vis.device
    _need_attr(bins)
    args = (_bins_args(bins, device, lead)
            + _sample_args(sample_offsets, clear_depth))
    _build.check("uniforms", uniforms, torch.float32, device, lead + (FU_LEN,))
    tex_h = tex_w = 0
    if shadow_map is not None:
        if shadow_map.dim() != len(lead) + 2 or \
                tuple(shadow_map.shape[:len(lead)]) != lead:
            raise ValueError(f"shadow_map: need a {lead + ('H', 'W')} depth "
                             f"map, got {tuple(shadow_map.shape)}")
        _build.check("shadow_map", shadow_map, torch.float32, device)
        tex_h, tex_w = shadow_map.shape[-2:]
    rgba = torch.empty(lead + (height, width, 4), dtype=torch.float32,
                       device=device)
    covf = torch.empty(lead + (height, width), dtype=torch.float32,
                       device=device)
    stream = _build.stream(device)
    split = _split_args(split_plan(bins, lead[0] if lead else 1), bins,
                        len(sample_offsets), device, stream)
    err = _lib().mr_render_fused(*args, _build.ptr(bins.attr),
                                 _build.ptr(uniforms), _build.ptr(shadow_map),
                                 tex_h, tex_w, width, height, _build.ptr(rgba),
                                 _build.ptr(covf), *split, stream)
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return rgba, covf


def render_fused(bins: TileBins, uniforms, shadow_map, width, height,
                 sample_offsets, clear_depth=1.0):
    """Raster + fragment stage + resolve (kernel K2). ``uniforms``:
    f32[FU_LEN]; ``shadow_map``: f32[SH, SW] or None. Returns (rgba
    f32[H,W,4], covered_frac f32[H,W]). CPU tensors go to the plain twin;
    CUDA tensors launch the kernel, and a failed launch raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return render_fused_plain(bins, uniforms, shadow_map, width, height,
                                  sample_offsets, clear_depth)
    return _launch_fused("render_fused", bins, uniforms, shadow_map, width,
                         height, sample_offsets, clear_depth, ())


def render_fused_batch(bins: TileBins, uniforms, shadow_maps, width,
                       height, sample_offsets, clear_depth=1.0):
    """K2 over a ``stack_bins`` frame batch in one launch (kernel K6).
    ``uniforms``: f32[F, FU_LEN]; ``shadow_maps``: f32[F, SH, SW] or None.
    Returns (rgba f32[F,H,W,4], covered_frac f32[F,H,W]). CPU tensors go to
    the plain twin; CUDA tensors launch the kernel, and a failed launch
    raises."""
    _check_grid(bins, width, height)
    if bins.vis.device.type == "cpu":
        return render_fused_batch_plain(bins, uniforms, shadow_maps, width,
                                        height, sample_offsets, clear_depth)
    return _launch_fused("render_fused_batch", bins, uniforms, shadow_maps,
                         width, height, sample_offsets, clear_depth,
                         (_frames(bins),))
