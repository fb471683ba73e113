"""Tile binning: triangle AABBs -> per-tile triangle lists (CSR).

Torch counterpart of ``metalrenderer_tpu.raster.binning``, rebuilt for the
GPU. The semantics are the JAX binning's; the layout is not:

  * Each triangle expands to (tile, tid) entries over the tiles its AABB
    spans (span cap K). A stable sort by tile of the tid-major entry array
    orders every tile's entries by tid, i.e. submission order. The kernels
    need no particular order (visibility is order-free, see
    ``raster_cuda``), but the lists are equal to the JAX binning's, which the
    tests check.
  * ``tile_offsets`` (CSR row pointers, from ``searchsorted``) delimit each
    tile's run of ``tile_tris``. Dead entries sort past the last tile.
  * Triangles spanning more than the cap go to one "big" list, live-first by
    tid, capped at ``big_capacity``; the overflow is counted in
    ``num_big_dropped`` and dropped, exactly as the JAX binning drops it.
  * Per-triangle field tables, read by the kernels by tid: visibility
    ``vis`` [T, 17] and the attributes ``attr`` [T, 48], each vertex's
    value/w, which a fragment weights by its sample's edge values.

No host synchronisation: every shape depends only on T and the tile grid.
"""
from __future__ import annotations

import dataclasses

import torch

from .geometry import TriangleSetup, scalar_planes

VIS_FIELDS = 17
# Attribute groups, each vertex's value/w (per-triangle constants ride as
# value * 1/w): 0-2 world xyz, 3-4 uv, 5-7 normal, 8 inv_w, 9 mat_kind,
# 10 tex_id, 11-13 color rgb, 14 normal_map_id. Padded to 16 groups,
# stored vertex-major per triangle: [v0's 16 groups | v1's | v2's]. A
# fragment interpolates group g as (l0*v0 + l1*v1) + l2*v2 with its
# sample's weights (raster_cuda), never as a plane of the screen position:
# on a sliver triangle a plane's coefficients scale with 1/area and cancel
# far from the origin.
ATTR_GROUPS = 15
ATTR_GROUPS_PADDED = 16
ATTR_FIELDS = ATTR_GROUPS_PADDED * 3    # 48
# Attribute groups double as the K3 G-buffer rows; its row 15 carries the
# pixel's covered-sample count.
ROW_WORLD = 0
ROW_UV = 3
ROW_NORMAL = 5
ROW_INVW = 8
ROW_MATKIND = 9
ROW_TEXID = 10
ROW_COLOR = 11
ROW_NMID = 14
ROW_DEPTH = 15
GOUT_ROWS = 16
# build_tri_fields stores each tid as f32 (field 16 of vis): integers are
# exact in f32 below 2^24.
MAX_TRIANGLES = 2 ** 24


def build_tri_fields(setup: TriangleSetup) -> torch.Tensor:
    """Per-triangle visibility fields [T, 17]:
    A0,B0,C0, A1,B1,C1, A2,B2,C2, az,bz,cz, tl0,tl1,tl2, valid, tid."""
    zplanes = scalar_planes(setup, setup.z)          # [T, 3]
    t = setup.valid.shape[0]
    dev = setup.valid.device
    return torch.cat([
        setup.edge.reshape(-1, 9),
        zplanes,
        setup.top_left.to(torch.float32),
        setup.valid.to(torch.float32)[:, None],
        torch.arange(t, dtype=torch.float32, device=dev)[:, None],
    ], dim=-1).contiguous()


def build_attr_fields(setup: TriangleSetup, pg) -> torch.Tensor:
    """Per-triangle attribute fields [T, 48]: each vertex's value/w of the
    16 groups, vertex-major (see above). ``pg``: the pass geometry
    (``vattrs`` [T,3,8], per-triangle material)."""
    iw = setup.inv_w[:, :, None]                     # [T, 3, 1]
    consts = torch.stack([
        pg.mat_kind.to(torch.float32),
        pg.tex_id.to(torch.float32),
        pg.mat_color[:, 0], pg.mat_color[:, 1], pg.mat_color[:, 2],
        pg.normal_map_id.to(torch.float32),
    ], dim=1)                                        # [T, 6]
    t = iw.shape[0]
    padded = torch.cat(
        [pg.vattrs * iw, iw, consts[:, None, :] * iw,
         torch.zeros((t, 3, ATTR_GROUPS_PADDED - ATTR_GROUPS),
                     dtype=torch.float32, device=iw.device)], dim=2)
    return padded.reshape(t, ATTR_FIELDS).contiguous()


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Binning result consumed by the raster kernels (all on one device)."""

    # The device tables below, in the order a prep lists them
    # (``passes.prep.tables``) and ``raster_cuda.stack_bins`` stacks them.
    TABLES = ("vis", "attr", "tile_offsets", "tile_tris", "big_ids",
              "big_aabb", "big_n", "num_big_dropped")

    tile_w: int
    tile_h: int
    ntx: int
    nty: int
    vis: torch.Tensor            # f32[T, 17] visibility fields
    attr: torch.Tensor           # f32[T, 48] per-vertex value/w, or None
    tile_offsets: torch.Tensor   # i32[NT+1] CSR row pointers into tile_tris
    tile_tris: torch.Tensor      # i32[T*span_cap] tids, tile-major by tid
    big_ids: torch.Tensor        # i32[cap] big-list tids, live first by tid
    big_aabb: torch.Tensor       # i32[cap, 4] floor/ceil AABB (dead: 0)
    big_n: torch.Tensor          # i32[1] live big-list length
    num_big_dropped: torch.Tensor  # i32[] big triangles beyond capacity


def _floor_tile(x, tile):
    """floor(x / tile) as int32, saturating like XLA's f32->i32 convert."""
    q = torch.floor(x / torch.full((), float(tile), dtype=x.dtype,
                                   device=x.device))
    return torch.clamp(q, -2.0**31, 2.0**31 - 128).to(torch.int32)


def bin_triangles(setup: TriangleSetup, fields, width, height,
                  tile_w, tile_h, span_cap=8, big_capacity=256,
                  attr_fields=None) -> TileBins:
    """Build per-tile triangle lists and the big list (see module doc).
    Raises ValueError for 2^24 triangles or more: ``vis`` carries each tid
    as f32, exact only below 2^24."""
    T = setup.valid.shape[0]
    if T >= MAX_TRIANGLES:
        raise ValueError(f"{T} triangles: the tids ride as f32 in vis, "
                         f"exact only below {MAX_TRIANGLES}")
    dev = fields.device
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    nt = ntx * nty

    aabb = setup.aabb
    tx0 = torch.clamp(_floor_tile(aabb[:, 0], tile_w), 0, ntx - 1)
    ty0 = torch.clamp(_floor_tile(aabb[:, 1], tile_h), 0, nty - 1)
    tx1 = torch.clamp(_floor_tile(aabb[:, 2], tile_w), 0, ntx - 1)
    ty1 = torch.clamp(_floor_tile(aabb[:, 3], tile_h), 0, nty - 1)
    on_screen = (aabb[:, 2] >= 0) & (aabb[:, 0] < width) & \
                (aabb[:, 3] >= 0) & (aabb[:, 1] < height)
    live = setup.valid & on_screen

    wspan = torch.clamp_min(tx1 - tx0 + 1, 1)
    hspan = ty1 - ty0 + 1
    span = wspan * hspan
    small = live & (span <= span_cap)
    big = live & (span > span_cap)

    # --- per-tile lists: tid-major (tri, j) entries, stable sort by tile ---
    j = torch.arange(span_cap, dtype=torch.int32, device=dev)[None, :]
    tile = (ty0[:, None] + j // wspan[:, None]) * ntx + \
        (tx0[:, None] + j % wspan[:, None])
    slot_ok = small[:, None] & (j < span[:, None])
    keys = torch.where(slot_ok, tile, nt).reshape(-1)
    tids = torch.arange(T, dtype=torch.int32,
                        device=dev)[:, None].expand(T, span_cap).reshape(-1)
    keys_sorted, perm = torch.sort(keys, stable=True)
    tile_tris = tids[perm].contiguous()
    tile_offsets = torch.searchsorted(
        keys_sorted, torch.arange(nt + 1, dtype=keys_sorted.dtype,
                                  device=dev)).to(torch.int32)

    # --- big list: live first, by tid, capped --------------------------------
    order = torch.sort((~big).to(torch.int32), stable=True).indices
    cap = min(big_capacity, T)
    big_ids = order[:cap]
    big_is_live = big[big_ids]
    n_big = big.to(torch.int32).sum()
    b = aabb[big_ids]
    baabb = torch.stack([torch.floor(b[:, 0]), torch.floor(b[:, 1]),
                         torch.ceil(b[:, 2]), torch.ceil(b[:, 3])], dim=1)
    baabb = torch.where(big_is_live[:, None], baabb, torch.zeros_like(baabb))
    big_aabb = torch.clamp(baabb, -2**30, 2**30).to(torch.int32)

    return TileBins(
        tile_w=tile_w, tile_h=tile_h, ntx=ntx, nty=nty,
        vis=fields, attr=attr_fields,
        tile_offsets=tile_offsets, tile_tris=tile_tris,
        big_ids=big_ids.to(torch.int32).contiguous(),
        big_aabb=big_aabb.contiguous(),
        big_n=torch.clamp_max(n_big, cap).to(torch.int32).reshape(1),
        num_big_dropped=torch.clamp_min(n_big - cap, 0).to(torch.int32),
    )
