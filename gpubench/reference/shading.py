"""Deferred shading of the benchmark's reference: a frozen copy of the
port's ``raster/shade.py`` (Blinn-Phong + emissive + shadow test +
textures + normal maps over SoA channel planes, per pixel or per MSAA
sample, in the port's expression order) with only its plain gather
samplers: every shadow, texture and normal-map lookup takes ``sampling``
at every fragment, as the port's reference backend does
(``tiled_sampler=False``), and no kernel is reached.
"""
from __future__ import annotations

import dataclasses

import torch

from . import sampling
from .scene import BLINN_PHONG_SHADOW, EMISSIVE


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Per-sample geometry buffers of the brute-force rasterizer
    (``reference_cpu.interpolate_gbuffer``)."""

    world: torch.Tensor      # f32[..., 3]
    normal: torch.Tensor     # f32[..., 3] (interpolated, not renormalized)
    uv: torch.Tensor         # f32[..., 2]
    depth: torch.Tensor      # f32[...] NDC z of the visible surface
    mat_kind: torch.Tensor   # i32[...]
    mat_color: torch.Tensor  # f32[..., 3]
    tex_id: torch.Tensor     # i32[...]
    normal_map_id: torch.Tensor  # i32[...] (-1 = none)
    covered: torch.Tensor    # bool[...] any geometry at this sample

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShadowContext:
    """Shadow pass output consumed by the main pass."""

    depth_map: torch.Tensor   # f32[S, S] light-space depth, or f32[F, S, S]
    light_m: torch.Tensor     # f32[4, 4] light_proj @ light_view


def _rsqrt_norm3(x, y, z):
    """1/||v|| for a 3-vector in SoA channels."""
    return 1.0 / torch.sqrt(x * x + y * y + z * z)


def _blinn_phong_soa(w, n, base, camera_pos, light_pos, light_color,
                     ambient_intensity, shininess, light_dir=None):
    """BlinnPhong.metal:44-57 / :66-77. Each argument is a tuple of channels
    (or a 3-vector of scalars for positions, colors and ``light_dir``).

    ``light_dir``: if given (pointing FROM the light), the light is
    directional: L = -normalize(light_dir), the same for every fragment.
    Otherwise L points at ``light_pos`` per fragment."""
    wx, wy, wz = w
    nx, ny, nz = n
    vx = camera_pos[0] - wx
    vy = camera_pos[1] - wy
    vz = camera_pos[2] - wz
    inv = _rsqrt_norm3(vx, vy, vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    if light_dir is not None:
        inv = _rsqrt_norm3(light_dir[0], light_dir[1], light_dir[2])
        lx, ly, lz = (-light_dir[0] * inv, -light_dir[1] * inv,
                      -light_dir[2] * inv)
    else:
        lx = light_pos[0] - wx
        ly = light_pos[1] - wy
        lz = light_pos[2] - wz
        inv = _rsqrt_norm3(lx, ly, lz)
        lx, ly, lz = lx * inv, ly * inv, lz * inv
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    inv = _rsqrt_norm3(hx, hy, hz)
    hx, hy, hz = hx * inv, hy * inv, hz * inv

    diff = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
    spec = torch.pow(torch.clamp_min(nx * hx + ny * hy + nz * hz, 0.0),
                     shininess)
    # (ambient + diffuse + specular) shares the lightColor factor.
    s = ambient_intensity + diff + spec
    return (s * light_color[0] * base[0],
            s * light_color[1] * base[1],
            s * light_color[2] * base[2])


def _sample2d_untiled(tex, u, v, address_mode, oob_value=None, mask=None):
    """The plain gather sampler at every fragment, whatever ``mask`` and
    ``oob_value`` say; per-frame maps
    f32[F, S, S] at [F, H, W] planes frame by frame."""
    if tex.dim() == 3:
        return torch.stack([_sample2d_untiled(t, uu, vv, address_mode)
                            for t, uu, vv in zip(tex, u, v)])
    return sampling.sample_bilinear(tex[..., None], u, v, address_mode)[..., 0]


def _shadow_coords(w, light_m):
    """Light-space lookup of world positions ``w`` (BlinnPhong.metal:79-90):
    (u, v, the fragment's remapped depth, uv inside [0,1]^2)."""
    wx, wy, wz = w
    m = light_m
    lx = m[0, 0] * wx + m[0, 1] * wy + m[0, 2] * wz + m[0, 3]
    ly = m[1, 0] * wx + m[1, 1] * wy + m[1, 2] * wz + m[1, 3]
    lz = m[2, 0] * wx + m[2, 1] * wy + m[2, 2] * wz + m[2, 3]
    lw = m[3, 0] * wx + m[3, 1] * wy + m[3, 2] * wz + m[3, 3]
    inv_w = 1.0 / lw
    u = lx * inv_w * 0.5 + 0.5
    v = (1.0 - ly * inv_w) * 0.5             # self-consistent viewport map
    shadow_depth = lz * inv_w * 0.5 + 0.5    # reference depth remap quirk
    in_bounds = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return u, v, shadow_depth, in_bounds


def _shadow_factor_soa(w, light_m, depth_map, bias, factor, needs):
    """BlinnPhong.metal:79-96. ``light_m`` = light_proj @ light_view
    (f32[4,4]); ``depth_map`` f32[S, S], or one map per frame f32[F, S, S]
    for [F, H, W] planes; ``needs``: fragments whose material runs the
    test (the plain sampler reads the map at every fragment; ``needs``
    selects nothing here). Returns ``factor`` where a fragment's
    light-space uv lies in [0,1]^2 and it is shadowed, else 1."""
    u, v, shadow_depth, in_bounds = _shadow_coords(w, light_m)
    d = _sample2d_untiled(depth_map, u, v, sampling.REPEAT, 1.0,
                          in_bounds & needs)
    shadowed = (shadow_depth - bias) > d
    one = torch.ones_like(u)
    return torch.where(in_bounds & shadowed, factor * one, one)


def _ddx(a):
    return torch.roll(a, -1, dims=-1) - a


def _ddy(a):
    return torch.roll(a, -1, dims=-2) - a


def _texture_lod(u, v, tex_w, tex_h):
    """Per-pixel isotropic LOD from screen-space uv derivatives (the
    dFdx/dFdy equivalent: finite differences along framebuffer axes)."""
    return sampling.mip_level_from_uv_derivatives(
        _ddx(u), _ddx(v), _ddy(u), _ddy(v), tex_w, tex_h)


def _sample_rgb(mips, u, v):
    """Texture RGB in SoA channels, trilinear at the pixel's LOD (bilinear
    for a single-level texture), by the plain gather sampler at every
    pixel."""
    if len(mips) > 1:
        lod = _texture_lod(u, v, mips[0].shape[1], mips[0].shape[0])
    else:
        lod = torch.zeros_like(u)
    t = sampling.sample_trilinear(mips, u, v, lod)
    return t[..., 0], t[..., 1], t[..., 2]


def _resolve_base_color_soa(base, tex_id, u, v, textures):
    """A texture sample replaces materialColor where tex_id selects it
    (Metal-Tutorial textured path)."""
    for i, mips in enumerate(textures):
        sel = tex_id == i
        tex = _sample_rgb(mips, u, v)
        base = tuple(torch.where(sel, tex[c], base[c]) for c in range(3))
    return base


def _norm3(x, y, z):
    r = torch.sqrt(x * x + y * y + z * z)
    s = torch.where(r > 1e-12, 1.0 / r, torch.zeros_like(r))
    return x * s, y * s, z * s


def _apply_normal_maps_soa(w, n, u, v, covered, textures, normal_map_ids):
    """Tangent-space normal mapping from screen-space derivatives (BASELINE
    config 4; the reference has no normal mapping). Deferred-style TBN:
    tangent and bitangent come from finite differences of world position
    and uv along the framebuffer axes, so no per-vertex tangents are
    needed."""
    if not textures:
        return n
    wx, wy, wz = w
    dwx_x, dwy_x, dwz_x = _ddx(wx), _ddx(wy), _ddx(wz)
    dwx_y, dwy_y, dwz_y = _ddy(wx), _ddy(wy), _ddy(wz)
    du_x, dv_x = _ddx(u), _ddx(v)
    du_y, dv_y = _ddy(u), _ddy(v)

    det = du_x * dv_y - dv_x * du_y
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                      torch.zeros_like(det))
    tx = (dwx_x * dv_y - dwx_y * dv_x) * inv
    ty = (dwy_x * dv_y - dwy_y * dv_x) * inv
    tz = (dwz_x * dv_y - dwz_y * dv_x) * inv
    bx = (dwx_y * du_x - dwx_x * du_y) * inv
    by = (dwy_y * du_x - dwy_x * du_y) * inv
    bz = (dwz_y * du_x - dwz_x * du_y) * inv

    tx, ty, tz = _norm3(tx, ty, tz)
    bx, by, bz = _norm3(bx, by, bz)
    nx, ny, nz = _norm3(*n)

    out = n
    for i, mips in enumerate(textures):
        use = (normal_map_ids == i) & covered
        m0, m1, m2 = _sample_rgb(mips, u, v)
        m0 = m0 * 2.0 - 1.0
        m1 = m1 * 2.0 - 1.0
        m2 = m2 * 2.0 - 1.0
        px = tx * m0 + bx * m1 + nx * m2
        py = ty * m0 + by * m1 + ny * m2
        pz = tz * m0 + bz * m1 + nz * m2
        px, py, pz = _norm3(px, py, pz)
        out = (torch.where(use, px, out[0]), torch.where(use, py, out[1]),
               torch.where(use, pz, out[2]))
    return out


_SELECTED = ("wx", "wy", "wz", "nx", "ny", "nz", "u", "v", "kind", "texid",
             "nmid", "cr", "cg", "cb")


def _first_covered(planes, covered):
    """Each of ``planes`` ([S, H, W]) at the pixel's first covered sample
    (sample 0's where none is), and any-covered bool[H, W]."""
    sel = [p[0] for p in planes]
    cov_any = covered[0]
    for si in range(1, covered.shape[0]):
        use = (~cov_any) & covered[si]
        sel = [torch.where(use, p[si], q) for p, q in zip(planes, sel)]
        cov_any = cov_any | covered[si]
    return sel, cov_any


def _select_first_covered(ch):
    """Per-pixel channel planes at the FIRST covered sample: Metal runs the
    fragment shader once per pixel, not once per MSAA sample."""
    keys = [k for k in _SELECTED if ch.get(k) is not None]
    sel, cov_any = _first_covered([ch[k] for k in keys], ch["covered"])
    return dict(ch, covered=cov_any, **dict(zip(keys, sel)))


def shade_channels(ch, camera_pos, light_pos, light_color,
                   ambient_intensity, shininess, clear_color,
                   shadow: ShadowContext = None, textures=(),
                   shadow_bias=0.005, shadow_factor_value=0.5,
                   light_dir=None, shadow_per_pixel=True, per_pixel=True):
    """The fragment stage over SoA channel planes -> (r, g, b, a) planes.

    ``ch``: wx wy wz, nx ny nz, u v, kind, texid, nmid, cr cg cb, covered
    planes, in one of two layouts:
      * per pixel, [H, W] with ``cov_frac`` (``channels_from_gout_px``):
        the fragment of each pixel's first covered sample. Coverage is
        resolved by blending with the clear color by ``cov_frac``; returns
        [H, W] planes. Batch-transparent: planes may be [F, H, W], with
        ``camera_pos`` per frame as [3, F, 1, 1] and ``shadow.depth_map``
        per frame as [F, S, S];
      * per sample, [S, H, W] without ``cov_frac``
        (``channels_from_gout``). ``per_pixel`` (the default) shades once
        per pixel at the first covered sample's channels and blends by the
        covered share of the S samples: [H, W] planes (for S == 1 the one
        sample is shaded as below). ``per_pixel=False`` shades every
        sample (supersampling), uncovered samples take the clear color,
        and the caller box-resolves the [S, H, W] planes;
        ``shadow_per_pixel`` then tests the shadow map once per pixel, at
        the first covered sample's world position, else once per sample.
    Scalars (positions, colors, ambient, shininess, clear color, bias,
    factor, ``light_dir``) may be numbers or tensors; ``textures``: mip
    chains on the planes' device.
    """
    dev = ch["wx"].device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    camera_pos, light_pos = vec(camera_pos), vec(light_pos)
    light_color, clear = vec(light_color), vec(clear_color)
    if light_dir is not None:
        light_dir = vec(light_dir)

    # A leading axis means samples only without ``cov_frac``: the frame
    # batch carries [F, H, W] per-pixel planes with it.
    sample_planes = ch.get("cov_frac") is None
    cov_frac = ch.get("cov_frac") if per_pixel else None
    if (per_pixel and sample_planes and ch["covered"].dim() == 3
            and ch["covered"].shape[0] > 1):
        cov_frac = torch.mean(ch["covered"].to(torch.float32), dim=0)
        ch = _select_first_covered(ch)

    w = (ch["wx"], ch["wy"], ch["wz"])
    n = (ch["nx"], ch["ny"], ch["nz"])
    u, v = ch["u"], ch["v"]
    base = (ch["cr"], ch["cg"], ch["cb"])
    covered = ch["covered"]

    if ch.get("nmid") is not None:
        n = _apply_normal_maps_soa(w, n, u, v, covered, textures, ch["nmid"],
                                   )
    base = _resolve_base_color_soa(base, ch["texid"], u, v, textures,
                                   )

    lit = _blinn_phong_soa(w, n, base, camera_pos, light_pos, light_color,
                           ambient_intensity, shininess, light_dir)
    emissive = ch["kind"] == EMISSIVE
    r = torch.where(emissive, base[0], lit[0])
    g = torch.where(emissive, base[1], lit[1])
    b = torch.where(emissive, base[2], lit[2])
    a = torch.ones_like(r)

    if shadow is not None:
        receives = ch["kind"] == BLINN_PHONG_SHADOW
        if shadow_per_pixel and sample_planes and covered.dim() == 3:
            # One shadow test per pixel at the first covered sample's world
            # position (Metal shades fragments per pixel, not per sample).
            w0, _ = _first_covered(w, covered)
            sf = _shadow_factor_soa(w0, shadow.light_m, shadow.depth_map,
                                    shadow_bias, shadow_factor_value,
                                    torch.any(receives & covered, dim=0))
            sf = sf[None].expand(covered.shape)
        else:
            sf = _shadow_factor_soa(w, shadow.light_m, shadow.depth_map,
                                    shadow_bias, shadow_factor_value,
                                    receives & covered)
        # fragColor * shadow multiplies all four channels
        # (BlinnPhong.metal:96).
        msk = torch.where(receives, sf, torch.ones_like(sf))
        r, g, b, a = r * msk, g * msk, b * msk, a * msk

    if cov_frac is not None:
        # Per-sample coverage resolve: every covered sample of a pixel
        # carries the per-pixel fragment color, uncovered samples the clear
        # color; the MSAA box filter reduces to this blend.
        keep = 1.0 - cov_frac
        return (r * cov_frac + clear[0] * keep, g * cov_frac + clear[1] * keep,
                b * cov_frac + clear[2] * keep, a * cov_frac + clear[3] * keep)
    return tuple(torch.where(covered, c, clear[i].expand_as(c))
                 for i, c in enumerate((r, g, b, a)))


def channels_from_gbuffer(gbuf: GBuffer):
    """SoA channel planes of an AoS G-buffer (the reference backend's)."""
    return {
        "wx": gbuf.world[..., 0], "wy": gbuf.world[..., 1],
        "wz": gbuf.world[..., 2],
        "nx": gbuf.normal[..., 0], "ny": gbuf.normal[..., 1],
        "nz": gbuf.normal[..., 2],
        "u": gbuf.uv[..., 0], "v": gbuf.uv[..., 1],
        "kind": gbuf.mat_kind, "texid": gbuf.tex_id,
        "nmid": gbuf.normal_map_id,
        "cr": gbuf.mat_color[..., 0], "cg": gbuf.mat_color[..., 1],
        "cb": gbuf.mat_color[..., 2],
        "covered": gbuf.covered,
    }
