"""Brute-force golden rasterizer of the benchmark's reference.

A frozen copy of the port's ``raster/reference_cpu.py`` with its imports
rewritten to this package, plus ``count_fragments`` (the roofline's work
count); it runs on any device. A deliberately simple implementation of the
fixed-function semantics: the top-left coverage rule, the near/far test
``0 <= z <= 1``, the LessEqual depth test from a clear depth of 1.0 and the
submission-order tie-break (mtl_engine.mm:436-439, :829-830). It shares
triangle setup with the kernels but nothing of binning: every triangle is
tested against every sample of its own screen box, so a fault in the tile
lists shows as a difference from this oracle.

Where the JAX version scans one triangle at a time, this one evaluates a
chunk of triangles at once: each live triangle expands to the pixels of its
bounding box (from ``setup.screen``, with a one-pixel margin), the chunk's
(triangle, pixel) pairs are evaluated one sample position at a time, and
visibility resolves by a scatter minimum of a packed int64 key
``(z bits << 32) | (2^31 - 1 - tid)``. The scan's rule ``zp <= zbuf`` from
a clear depth of 1.0 keeps the lexicographic minimum of ``(zp, -tid)``: the
nearest depth, and of equal depths the later triangle. The minimum does not
depend on the order the chunks arrive in. ``-0.0`` folds into ``+0.0`` in
the key only (the two compare equal); the depth written is the winner's own
``zp``, evaluated again by the same operations.

Rounding: separate eager multiplies and adds (no ``addcmul``, no
``torch.compile``, no BLAS), so the CPU and CUDA runs give the same bits.
``anchor=(tile_w, tile_h)`` evaluates the edge and depth planes with the
kernels' tile-anchored association ``c' = (c + a*ox) + b*oy`` and then
``(a*xr + b*yr) + c'``; ``anchor=None`` keeps the independent direct
barycentrics.
"""
from __future__ import annotations

import torch

from .geometry import TriangleSetup, scalar_planes
from .shading import GBuffer

# (triangle, pixel) pairs a chunk evaluates at once, per sample position:
# a chunk's temporaries stay within ~2 GB. A box larger than this (at most
# W*H pixels) is a chunk of its own.
PAIR_BUDGET = 1 << 24
_NO_HIT = torch.iinfo(torch.int64).max
_TID_MAX = (1 << 31) - 1


def _offsets(sample_positions, device):
    return torch.as_tensor(sample_positions, dtype=torch.float32,
                           device=device).reshape(-1, 2)


def _plane_coords(pxi, pyi, offx, offy, anchor):
    """Coordinates of the samples at integer pixels ``pxi``, ``pyi``
    (int64) plus the sample offset (``offx``, ``offy``: f32): (sx, sy), or
    with ``anchor=(tile_w, tile_h)`` the tile-relative sample position and
    the tile base (xr, yr, ox, oy)."""
    if anchor is None:
        return pxi.to(torch.float32) + offx, pyi.to(torch.float32) + offy
    tile_w, tile_h = anchor
    return ((pxi % tile_w).to(torch.float32) + offx,
            (pyi % tile_h).to(torch.float32) + offy,
            ((pxi // tile_w) * tile_w).to(torch.float32),
            ((pyi // tile_h) * tile_h).to(torch.float32))


def _eval_plane(a, b, c, coords):
    """``a*x + b*y + c`` at ``coords``, in the kernels' association when the
    coordinates are tile-anchored."""
    if len(coords) == 4:
        xr, yr, ox, oy = coords
        c_adj = (c + a * ox) + b * oy
        return (a * xr + b * yr) + c_adj
    sx, sy = coords
    return a * sx + b * sy + c


def _grid(width, height, device):
    ys = torch.arange(height, dtype=torch.int64, device=device)
    xs = torch.arange(width, dtype=torch.int64, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def _sample_grid(width, height, sample_positions, device="cpu"):
    """Pixel-sample coordinates: f32[S, H, W] x 2."""
    pyi, pxi = _grid(width, height, device)
    offs = _offsets(sample_positions, device)
    return _plane_coords(pxi[None], pyi[None], offs[:, 0, None, None],
                         offs[:, 1, None, None], None)


def _anchored_grid(width, height, sample_positions, anchor, device="cpu"):
    """Tile-anchored coordinates of the kernels' plane arithmetic:
    (tile-relative sample coordinates xr, yr, tile bases ox, oy), all
    f32[S, H, W]. anchor = (tile_w, tile_h)."""
    pyi, pxi = _grid(width, height, device)
    offs = _offsets(sample_positions, device)
    return _plane_coords(pxi[None], pyi[None], offs[:, 0, None, None],
                         offs[:, 1, None, None], anchor)


def _depth_at(coef, coords):
    """The candidate's edge values e[3] and depth ``zp`` at ``coords``.
    ``coef``: planes per candidate, [..., 13]: edges (a, b, c) x 3, then the
    depth plane (anchored) or z0, z1, z2 and inv_area (independent)."""
    e = [_eval_plane(coef[..., 3 * k], coef[..., 3 * k + 1],
                     coef[..., 3 * k + 2], coords) for k in range(3)]
    if len(coords) == 4:
        zp = _eval_plane(coef[..., 9], coef[..., 10], coef[..., 11], coords)
    else:
        inv_area = coef[..., 12]
        lam0 = e[1] * inv_area
        lam1 = e[2] * inv_area
        lam2 = e[0] * inv_area
        zp = lam0 * coef[..., 9] + lam1 * coef[..., 10] + lam2 * coef[..., 11]
    return e, zp


def _hit(e, zp, top_left):
    """The top-left coverage rule on the edge values ``e`` (``top_left``:
    bool[..., 3]) and Metal's clip volume 0 <= z <= w, i.e. NDC z in
    [0, 1]."""
    cov = (torch.where(top_left[..., 0], e[0] >= 0.0, e[0] > 0.0)
           & torch.where(top_left[..., 1], e[1] >= 0.0, e[1] > 0.0)
           & torch.where(top_left[..., 2], e[2] >= 0.0, e[2] > 0.0))
    return cov & (zp >= 0.0) & (zp <= 1.0)


def _plane_table(setup: TriangleSetup, anchor):
    """f32[T, 13] per-triangle planes for ``_depth_at``."""
    t = setup.edge.shape[0]
    if anchor is not None:
        zpl = scalar_planes(setup, setup.z)
    else:
        zpl = setup.z
    return torch.cat([setup.edge.reshape(t, 9), zpl,
                      setup.inv_area[:, None]], dim=1)


def _boxes(setup: TriangleSetup, width, height, offs):
    """Per-triangle pixel boxes (x0, y0, x1, y1 inclusive, int64) that hold
    every sample the triangle can cover: the screen-space extent less the
    sample offsets, widened by a pixel, clipped to the screen; and the
    triangles that are valid with a non-empty box."""
    def lo(v, off_max, size):
        v = torch.where(setup.valid, torch.amin(v, dim=1) - off_max,
                        torch.full_like(v[:, 0], float(size)))
        return torch.clamp(torch.floor(v) - 1.0, 0.0, float(size)).to(
            torch.int64)

    def hi(v, off_min, size):
        v = torch.where(setup.valid, torch.amax(v, dim=1) - off_min,
                        torch.full_like(v[:, 0], -1.0))
        return torch.clamp(torch.ceil(v) + 1.0, -1.0, float(size - 1)).to(
            torch.int64)

    sx, sy = setup.screen[..., 0], setup.screen[..., 1]
    x0 = lo(sx, offs[:, 0].max(), width)
    y0 = lo(sy, offs[:, 1].max(), height)
    x1 = hi(sx, offs[:, 0].min(), width)
    y1 = hi(sy, offs[:, 1].min(), height)
    live = setup.valid & (x0 <= x1) & (y0 <= y1)
    return x0, y0, x1, y1, live


def _chunks(cum, budget):
    """Split the live triangles (inclusive prefix sums ``cum`` of their box
    pixels, on the CPU) into runs of at most ``budget`` pixels, a larger box
    alone: yields (start, end, pixels before start, pixels in the run)."""
    start, n = 0, cum.shape[0]
    while start < n:
        base = int(cum[start - 1]) if start else 0
        end = max(int(torch.searchsorted(cum, base + budget, right=True)),
                  start + 1)
        yield start, end, base, int(cum[end - 1]) - base
        start = end


def rasterize_brute_force(setup: TriangleSetup, width, height,
                          sample_positions, anchor=None):
    """Visibility: returns (depth f32[S,H,W], winner i32[S,H,W]; -1 = none).

    ``anchor=(tile_w, tile_h)`` evaluates the edge and z planes
    (``scalar_planes(setup, setup.z)``) with the kernels' tile-relative
    association, so depth rounds as the kernels round it and z-fighting
    samples resolve to the same winner; ``None`` keeps the independent
    direct barycentrics (``e*inv_area`` weighting ``z``)."""
    device = setup.edge.device
    offs = _offsets(sample_positions, device)
    n_s = offs.shape[0]
    plane = width * height
    table = _plane_table(setup, anchor)
    x0, y0, x1, y1, live = _boxes(setup, width, height, offs)
    ids = torch.nonzero(live).squeeze(1)
    bw = x1 - x0 + 1
    pixels = (bw * (y1 - y0 + 1))[ids]
    cum = torch.cumsum(pixels, dim=0)
    keys = torch.full((n_s * plane,), _NO_HIT, dtype=torch.int64,
                      device=device)
    for start, end, base, total in _chunks(cum.cpu(), PAIR_BUDGET):
        tri_local = torch.repeat_interleave(
            torch.arange(end - start, device=device), pixels[start:end],
            output_size=total)
        first = cum[start:end] - pixels[start:end] - base
        pos = torch.arange(total, device=device) - first[tri_local]
        tri = ids[start:end][tri_local]
        del tri_local, first
        w_box = bw[tri]
        pxi = x0[tri] + pos % w_box
        pyi = y0[tri] + pos // w_box
        del pos, w_box
        coef = table[tri]
        top_left = setup.top_left[tri]
        pix = pyi * width + pxi
        tid_key = _TID_MAX - tri
        for s in range(n_s):
            e, zp = _depth_at(coef, _plane_coords(pxi, pyi, offs[s, 0],
                                                  offs[s, 1], anchor))
            hit = _hit(e, zp, top_left)
            zbits = torch.where(zp == 0.0, torch.zeros_like(zp), zp).view(
                torch.int32).to(torch.int64)
            key = torch.where(hit, (zbits << 32) | tid_key,
                              torch.full_like(zbits, _NO_HIT))
            keys.scatter_reduce_(0, pix + s * plane, key, "amin")
    keys = keys.reshape(n_s, height, width)
    hit = keys != _NO_HIT
    winner = torch.where(hit, _TID_MAX - (keys & 0xFFFFFFFF),
                         torch.full_like(keys, -1)).to(torch.int32)
    # The winner's own depth, by the same operations as above.
    coef = table[torch.clamp_min(winner, 0).to(torch.int64)]
    _, zp = _depth_at(coef, _anchored_grid(width, height, sample_positions,
                                           anchor, device)
                      if anchor is not None else
                      _sample_grid(width, height, sample_positions, device))
    depth = torch.where(hit, zp, torch.ones_like(zp))
    return depth, winner


def interpolate_gbuffer(setup: TriangleSetup, winner, width, height,
                        sample_positions, vattrs, mat_kind, mat_color, tex_id,
                        depth, normal_map_id=None) -> GBuffer:
    """Perspective-correct attribute interpolation for the visible triangle.

    vattrs: per-triangle vertex attributes [T, 3, 8] (world xyz | uv |
    normal xyz). Gathers the winning triangle's data per sample and applies
    the 1/w weighting (Metal [[stage_in]] interpolation), one sample
    position at a time so the gathers stay one [H, W] plane's worth.
    ``normal_map_id=None`` reads as -1 (no normal map) everywhere."""
    device = winner.device
    pyi, pxi = _grid(width, height, device)
    offs = _offsets(sample_positions, device)
    interp = []
    for s in range(offs.shape[0]):
        sx, sy = _plane_coords(pxi, pyi, offs[s, 0], offs[s, 1], None)
        t = torch.clamp_min(winner[s], 0).to(torch.int64)
        edge = setup.edge[t]                                # [H,W,3,3]
        inv_area = setup.inv_area[t]
        inv_w = setup.inv_w[t]                              # [H,W,3]
        e = (edge[..., 0] * sx[..., None] + edge[..., 1] * sy[..., None]
             + edge[..., 2])                                # [H,W,3]
        lam = torch.stack([e[..., 1], e[..., 2], e[..., 0]], dim=-1) * \
            inv_area[..., None]
        wgt = lam * inv_w
        denom = (wgt[..., 0:1] + wgt[..., 1:2]) + wgt[..., 2:3]
        wgt = wgt / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        g = vattrs[t]                                       # [H,W,3,8]
        interp.append((g[..., 0, :] * wgt[..., 0, None]
                       + g[..., 1, :] * wgt[..., 1, None])
                      + g[..., 2, :] * wgt[..., 2, None])
    interp = torch.stack(interp)                            # [S,H,W,8]

    covered = winner >= 0
    t = torch.clamp_min(winner, 0).to(torch.int64)
    if normal_map_id is None:
        normal_map_id = torch.full_like(mat_kind, -1)
    return GBuffer(
        world=interp[..., 0:3],
        normal=interp[..., 5:8],
        uv=interp[..., 3:5],
        depth=depth,
        mat_kind=torch.where(covered, mat_kind[t], -1),
        mat_color=mat_color[t],
        tex_id=torch.where(covered, tex_id[t], -1),
        normal_map_id=torch.where(covered, normal_map_id[t], -1),
        covered=covered,
    )


def rasterize_depth_brute_force(setup: TriangleSetup, width, height,
                                anchor=None):
    """Depth-only pass (the shadow map): one sample at the pixel center,
    clear depth 1.0 (createShadowPassDescriptor, mtl_engine.mm:623-634)."""
    depth, _ = rasterize_brute_force(setup, width, height, ((0.5, 0.5),),
                                     anchor=anchor)
    return depth[0]


def depth_at_samples(setup: TriangleSetup, width, height, sample_positions,
                     samples, tris, anchor=None):
    """The depth of triangle ``tris[i]`` at sample ``samples[i]`` (flat
    int64 indices into [S, H, W]) by the oracle's arithmetic, and whether
    the triangle covers the sample within ``0 <= z <= 1``: (f32[n],
    bool[n]). Where two rasterizers pick different winners at a sample,
    this says whether both cover it at depths within the rounding of the
    plane arithmetic: a z-fight, whose winner either may pick."""
    device = setup.edge.device
    offs = _offsets(sample_positions, device)
    samples = samples.to(device=device, dtype=torch.int64)
    tris = tris.to(device=device, dtype=torch.int64)
    plane = width * height
    s = samples // plane
    coords = _plane_coords(samples % width, (samples % plane) // width,
                           offs[s, 0], offs[s, 1], anchor)
    e, zp = _depth_at(_plane_table(setup, anchor)[tris], coords)
    return zp, _hit(e, zp, setup.top_left[tris])


def count_fragments(setup: TriangleSetup, width, height, sample_positions):
    """The fragments a frame needs: the (triangle, sample) pairs whose
    sample a valid triangle covers within ``0 <= z <= 1``, before any depth
    test, by the direct barycentrics (no tile anchor), so the count follows
    the frame alone and not how a rasterizer bins or tiles it. Returns an
    int."""
    device = setup.edge.device
    offs = _offsets(sample_positions, device)
    table = _plane_table(setup, None)
    x0, y0, x1, y1, live = _boxes(setup, width, height, offs)
    ids = torch.nonzero(live).squeeze(1)
    bw = x1 - x0 + 1
    pixels = (bw * (y1 - y0 + 1))[ids]
    cum = torch.cumsum(pixels, dim=0)
    total_hits = torch.zeros((), dtype=torch.int64, device=device)
    for start, end, base, total in _chunks(cum.cpu(), PAIR_BUDGET):
        tri_local = torch.repeat_interleave(
            torch.arange(end - start, device=device), pixels[start:end],
            output_size=total)
        first = cum[start:end] - pixels[start:end] - base
        pos = torch.arange(total, device=device) - first[tri_local]
        tri = ids[start:end][tri_local]
        w_box = bw[tri]
        pxi = x0[tri] + pos % w_box
        pyi = y0[tri] + pos // w_box
        coef = table[tri]
        top_left = setup.top_left[tri]
        for s in range(offs.shape[0]):
            e, zp = _depth_at(coef, _plane_coords(pxi, pyi, offs[s, 0],
                                                  offs[s, 1], None))
            total_hits += _hit(e, zp, top_left).sum()
    return int(total_hits)
