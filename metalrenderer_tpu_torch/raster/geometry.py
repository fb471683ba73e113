"""Triangle setup: clip space -> screen space, edge equations, fill rule.

Torch counterpart of ``metalrenderer_tpu.raster.geometry`` (same functions,
same operation order). Every per-pixel quantity of a triangle — edge
functions, NDC depth, 1/w and attribute/w — is an affine function of the
screen position, so setup emits plane coefficients ``(A, B, C)`` with
``value(p) = A*sx + B*sy + C``.

Screen mapping (Metal viewport): sx = (ndc.x + 1) * W/2,
sy = (1 - ndc.y) * H/2 (row 0 at the top).

Fill rule: D3D/Metal top-left. With inside-positive edges in y-down screen
coordinates, a sample exactly on an edge is covered iff the edge is
horizontal pointing +x (top edge) or has dy < 0 (left edge).

Rounding: every expression is a chain of separate eager f32 ops (no
``addcmul``, no ``torch.compile``, no BLAS), so the CPU and CUDA runs of
the port give the same bits; ``guard_clip_xy``'s TwoSum/TwoProd depend on it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TriangleSetup:
    """Per-triangle rasterization data (struct-of-arrays over T triangles)."""

    valid: torch.Tensor      # bool[T] passes reject tests (w, area, cull)
    screen: torch.Tensor     # f32[T, 3, 2] screen-space vertex positions
    z: torch.Tensor          # f32[T, 3] NDC depth per vertex (Metal [0,1])
    inv_w: torch.Tensor      # f32[T, 3] 1/clip.w per vertex
    edge: torch.Tensor       # f32[T, 3, 3] oriented (A,B,C) per edge
                             # order: [e01, e12, e20]; inside => all >= 0
    top_left: torch.Tensor   # bool[T, 3] top-left flag per edge
    inv_area: torch.Tensor   # f32[T] 1 / oriented (positive) double-area
    aabb: torch.Tensor       # f32[T, 4] (xmin, ymin, xmax, ymax) pixel coords

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def clip_to_screen(clip, width, height, near_eps=1e-6):
    """Perspective divide + viewport map. clip: f32[T,3,4].

    Returns (screen f32[T,3,2], z f32[T,3], inv_w f32[T,3], w_ok bool[T]).
    Triangles with any vertex w <= near_eps are flagged invalid.
    """
    w = clip[..., 3]
    w_ok = torch.all(w > near_eps, dim=-1)
    safe_w = torch.where(w > near_eps, w, torch.ones_like(w))
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    screen = torch.stack([sx, sy], dim=-1)
    return screen, ndc[..., 2], inv_w, w_ok


def setup_triangles(clip, width, height, cull_backfaces=True,
                    near_eps=1e-6) -> TriangleSetup:
    """Batched triangle setup. clip: f32[T,3,4] (vertex order = winding).

    Front faces are CCW in NDC (mtl_engine.mm:829), i.e. negative signed
    double-area in y-down screen coordinates; edges are sign-flipped so that
    inside => all edge functions >= 0 regardless of facing.
    """
    screen, z, inv_w, w_ok = clip_to_screen(clip, width, height, near_eps)

    v0, v1, v2 = screen[:, 0], screen[:, 1], screen[:, 2]
    starts = torch.stack([v0, v1, v2], dim=1)          # [T,3,2]
    ends = torch.stack([v1, v2, v0], dim=1)            # [T,3,2]
    d = ends - starts                                  # [T,3,2] (dx, dy)

    area2 = (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - \
        (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])
    front = area2 < 0.0  # CCW in NDC => negative area after the y flip

    if cull_backfaces:
        facing_ok = front
        orient = torch.full_like(area2, -1.0)
    else:
        facing_ok = area2 != 0.0
        orient = torch.where(front, -1.0, 1.0).to(area2.dtype)

    do = d * orient[:, None, None]                     # oriented (dx, dy)
    dxo, dyo = do[..., 0], do[..., 1]
    ax, ay = starts[..., 0], starts[..., 1]
    # value(p) = dxo*(py - ay) - dyo*(px - ax)  =  A*px + B*py + C
    A = -dyo
    B = dxo
    C = dyo * ax - dxo * ay
    edge = torch.stack([A, B, C], dim=-1)              # [T,3,3]

    top_left = ((dyo == 0.0) & (dxo > 0.0)) | (dyo < 0.0)

    area_pos = orient * area2
    valid = w_ok & facing_ok & (area_pos > 0.0)
    safe_area = torch.where(area_pos == 0.0, torch.ones_like(area_pos),
                            area_pos)
    inv_area = torch.where(area_pos > 0.0, 1.0 / safe_area,
                           torch.zeros_like(area_pos))

    xmin = torch.amin(screen[..., 0], dim=1)
    xmax = torch.amax(screen[..., 0], dim=1)
    ymin = torch.amin(screen[..., 1], dim=1)
    ymax = torch.amax(screen[..., 1], dim=1)
    aabb = torch.stack([xmin, ymin, xmax, ymax], dim=-1)

    return TriangleSetup(
        valid=valid, screen=screen, z=z, inv_w=inv_w, edge=edge,
        top_left=top_left, inv_area=inv_area, aabb=aabb,
    )


def _lambda_planes(setup: TriangleSetup):
    """Barycentric planes: lambda_0 <- e12, lambda_1 <- e20, lambda_2 <- e01
    (the edges rolled by one: no index tensor to bring up from the host)."""
    return torch.roll(setup.edge, -1, dims=1) * setup.inv_area[:, None, None]


def scalar_planes(setup: TriangleSetup, vertex_scalars):
    """Planes of quantities interpolated WITHOUT perspective correction (NDC
    z and 1/w are affine in screen space). f32[T, 3] -> f32[T, 3] (A, B, C)."""
    lam = _lambda_planes(setup)
    out = vertex_scalars[:, 0, None] * lam[:, 0]
    for i in (1, 2):
        out = out + vertex_scalars[:, i, None] * lam[:, i]
    return out


def clip_near(clip, attrs=None):
    """Near-plane clipping in homogeneous clip space (Metal: keep z >= 0).

    Every input triangle yields exactly TWO output slots (a near clip makes
    at most 2 triangles); unused slots are degenerate (w=0 => rejected by
    setup). Output slots 2t/2t+1 derive from input t, preserving submission
    order for the LessEqual tie-break.

    clip: f32[T,3,4]; attrs: optional f32[T,3,D] interpolated alongside.
    Returns (clip2 f32[2T,3,4], attrs2 or None, parent i32[2T]).
    """
    T = clip.shape[0]
    data = clip if attrs is None else torch.cat([clip, attrs], dim=-1)
    d = clip[..., 2]                                     # z_clip
    inside = d >= 0.0                                    # [T,3]
    count = inside.to(torch.int32).sum(dim=-1)           # [T]

    # Rotation so the pattern is canonical: count==1 -> inside vertex first;
    # count==2 -> outside vertex last. argmax returns the first maximum.
    first_in = torch.argmax(inside.to(torch.int32), dim=-1)
    first_out = torch.argmax((~inside).to(torch.int32), dim=-1)
    r = torch.where(count == 1, first_in,
                    torch.where(count == 2, (first_out + 1) % 3,
                                torch.zeros_like(first_in)))
    idx = (torch.arange(3, device=clip.device)[None, :] + r[:, None]) % 3
    vrot = torch.gather(data, 1, idx[..., None].expand(-1, -1, data.shape[-1]))
    drot = torch.gather(d, 1, idx)

    def intersect(a, b, da, db):
        denom = da - db
        t = da / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        return a + t[..., None] * (b - a)

    v0, v1, v2 = vrot[:, 0], vrot[:, 1], vrot[:, 2]
    d0, d1, d2 = drot[:, 0], drot[:, 1], drot[:, 2]
    i01 = intersect(v0, v1, d0, d1)
    i12 = intersect(v1, v2, d1, d2)
    i20 = intersect(v2, v0, d2, d0)

    zero = torch.zeros_like(v0)
    c = count[:, None]

    t1v0 = torch.where(c == 0, zero, v0)
    t1v1 = torch.where(c >= 2, v1, torch.where(c == 1, i01, zero))
    t1v2 = torch.where(c == 3, v2, torch.where(c == 2, i12,
                                               torch.where(c == 1, i20, zero)))
    t2v0 = torch.where(c == 2, v0, zero)
    t2v1 = torch.where(c == 2, i12, zero)
    t2v2 = torch.where(c == 2, i20, zero)

    tri1 = torch.stack([t1v0, t1v1, t1v2], dim=1)        # [T,3,K]
    tri2 = torch.stack([t2v0, t2v1, t2v2], dim=1)
    out = torch.stack([tri1, tri2], dim=1).reshape(2 * T, 3, -1)
    # Each parent twice, by expand: no output size for the host to compute
    # (prepare_frame's graph capture forbids a host sync).
    parent = torch.arange(T, dtype=torch.int32,
                          device=clip.device)[:, None].expand(T, 2).reshape(-1)
    if attrs is None:
        return out[..., :4], None, parent
    return out[..., :4], out[..., 4:], parent


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (round-to-nearest f32)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """Dekker TwoProd via 12/12-bit splitting: p + err == a * b exactly
    (no FMA needed; eager f32 mul/add are IEEE round-to-nearest)."""
    def split(x):
        c = x * 4097.0          # 2**12 + 1 for the 24-bit f32 mantissa
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    return p, ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo


def _sh_clip_plane(verts, vcount, dist):
    """One Sutherland-Hodgman pass over padded polygons.

    verts: f32[N, V, K] (clip xyzw | attrs), vcount: i32[N] live vertex
    counts, dist: f32[N, V] signed distance per vertex (>= 0 inside).
    Returns (verts', vcount'). Kept vertices and crossing points are placed
    by an exact scatter (the JAX version's one-hot matmul selects the same
    values).
    """
    n, V, K = verts.shape
    idx = torch.arange(V, dtype=torch.int64, device=verts.device)[None, :]
    active = idx < vcount[:, None]                             # [N, V]
    nxt = torch.where(idx + 1 >= vcount[:, None], torch.zeros_like(idx),
                      idx + 1)
    vnext = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, K))
    dnext = torch.gather(dist, 1, nxt)

    inside = dist >= 0.0
    emit_v = active & inside                                   # keep vertex
    emit_x = active & (inside != (dnext >= 0.0))               # crossing
    denom = dist - dnext
    t = dist / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    # Compensated interpolation: v + t*(vn - v) in double-float, rounded
    # once, so the clip point stays on the true edge line.
    tt = t[..., None]
    dv, dv_e = _two_sum(vnext, -verts)
    p1, p1_e = _two_prod(tt, dv)
    s, s_e = _two_sum(verts, p1)
    xsect = s + (s_e + p1_e + tt * dv_e)

    counts = emit_v.to(torch.int64) + emit_x.to(torch.int64)
    pos_v = torch.cumsum(counts, dim=1) - counts               # excl. prefix
    pos_x = pos_v + emit_v.to(torch.int64)
    out_count = counts.sum(dim=1).to(torch.int32)

    # Scatter into V output slots plus one discard slot (index V).
    dest = torch.cat([torch.where(emit_v, pos_v, V),
                      torch.where(emit_x, pos_x, V)], dim=1)   # [N, 2V]
    src = torch.cat([verts, xsect], dim=1)                     # [N, 2V, K]
    out = torch.zeros((n, V + 1, K), dtype=verts.dtype, device=verts.device)
    out.scatter_(1, dest[..., None].expand(-1, -1, K), src)
    return out[:, :V], out_count


# A triangle cut by the four guard planes keeps at most 7 vertices (padded
# to 8), so it fans into at most 5 pieces: the side list's 5 a slot.
POLY_VERTS = 8
FAN_PIECES = POLY_VERTS - 3


def guard_clip_xy(clip2, attrs2, parent, width, height, cap=64,
                  guard_px=32768.0):
    """True homogeneous x/y clipping for beyond-envelope triangles.

    Triangles whose post-near-clip vertices land beyond ``guard_px`` screen
    pixels are pulled into a fixed-capacity side list, polygon-clipped
    against the four guard planes IN CLIP SPACE (x = +-gx*w, y = +-gy*w),
    fan-triangulated (<= 5 pieces) and appended after every main slot; the
    originals are killed. Overflow beyond ``cap`` leaves the original
    unclipped in place and is counted in the stats.

    Returns (clip_out [T2+5*cap,3,4], attrs_out, parent_out, stats dict).
    """
    t2 = clip2.shape[0]
    cap = min(cap, t2)
    gx = 2.0 * guard_px / float(width)
    gy = 2.0 * guard_px / float(height)

    w = clip2[..., 3]
    x = clip2[..., 0]
    y = clip2[..., 1]
    w_pos = torch.all(w > 0.0, dim=-1)
    oversize = w_pos & torch.any(
        (torch.abs(x) > gx * w) | (torch.abs(y) > gy * w), dim=-1)

    order = torch.sort((~oversize).to(torch.int32), stable=True).indices
    ids = order[:cap]                                          # oversize first
    live = oversize[ids]                                       # bool[cap]

    data = clip2 if attrs2 is None else torch.cat([clip2, attrs2], dim=-1)
    K = data.shape[-1]
    polys = data[ids]                                          # [cap, 3, K]
    verts = torch.cat([polys, torch.zeros((cap, POLY_VERTS - 3, K),
                                          dtype=data.dtype,
                                          device=data.device)], dim=1)
    vcount = torch.where(live, 3, 0).to(torch.int32)

    for dfun in (lambda v: gx * v[..., 3] - v[..., 0],
                 lambda v: v[..., 0] + gx * v[..., 3],
                 lambda v: gy * v[..., 3] - v[..., 1],
                 lambda v: v[..., 1] + gy * v[..., 3]):
        verts, vcount = _sh_clip_plane(verts, vcount, dfun(verts))

    # Fan triangulation: (v0, v_{k+1}, v_{k+2}) for k in 0..4.
    fans = []
    for k in range(FAN_PIECES):
        tri = torch.stack([verts[:, 0], verts[:, k + 1], verts[:, k + 2]],
                          dim=1)                               # [cap, 3, K]
        ok = (vcount >= k + 3)[:, None, None]
        fans.append(torch.where(ok, tri, torch.zeros_like(tri)))
    fan = torch.stack(fans, dim=1).reshape(cap * FAN_PIECES, 3, K)

    # Kill the clipped originals in the main list.
    killed = torch.where(live[:, None, None], torch.zeros_like(polys), polys)
    data = data.clone()
    data[ids] = killed

    parent_fan = parent[ids][:, None].expand(cap, FAN_PIECES).reshape(-1)
    data_out = torch.cat([data, fan], dim=0)
    parent_out = torch.cat([parent, parent_fan], dim=0)
    n_over = oversize.to(torch.int32).sum()
    stats = {"xyclip_triangles": torch.clamp_max(n_over, cap),
             "xyclip_dropped": torch.clamp_min(n_over - cap, 0)}
    if attrs2 is None:
        return data_out[..., :4], None, parent_out, stats
    return data_out[..., :4], data_out[..., 4:], parent_out, stats


def coverage(setup_edge, setup_top_left, px, py):
    """Top-left-rule coverage of a batch of sample positions.

    setup_edge: f32[..., 3, 3]; setup_top_left: bool[..., 3]; px, py:
    f32[P]. Returns bool[..., P]: the sample lies inside all three edges,
    or on an edge the fill rule keeps. (The brute-force reference's rule;
    the kernels evaluate the same planes on their tile grid.)"""
    e = (setup_edge[..., 0:1] * px + setup_edge[..., 1:2] * py
         + setup_edge[..., 2:3])                        # [..., 3, P]
    on_edge_ok = torch.where(setup_top_left[..., None], e >= 0.0, e > 0.0)
    return torch.all(on_edge_ok, dim=-2)
