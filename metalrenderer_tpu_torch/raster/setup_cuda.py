"""The main pass's geometry front end: a CUDA kernel with its plain twin.

``main_pass_tables`` turns the baked geometry and the camera's P @ V into
what the main pass's binning and raster kernels read: per slot the
visibility row ``vis`` [S, 17] and the attribute row ``attr`` [S, 48]
(``binning.build_tri_fields``, ``build_attr_fields``), the AABB and valid
flag (all ``binning.bin_triangles`` reads of the setup), and the stats.
The slots are the near clip's 2T (slots 2t, 2t+1 from input triangle t)
and, with the guard band on, 5 fan pieces for each of the side list's
``cap`` entries after them: S = 2T + 5 * cap.

The plain twin, ``main_pass_tables_plain``, is the eager chain:
``prepare_main_pass`` (projection, ``clip_near`` with attributes,
``guard_clip_xy``, ``setup_triangles``, the per-triangle material gathers)
and the two field builders. On the card the kernel (``csrc/setup.cu``)
computes each slot in registers and writes its rows once, where the chain
wrote and re-read every intermediate; it replaces no Pallas kernel (the
JAX prep is one XLA program, which fuses the chain). Its tables and stats
are bit-equal to the chain's. The guard band's side list takes three
launches: the tables pass flags oversize slots, torch's stable sort of
the flags picks the side list's ``cap`` slots (as ``guard_clip_xy``
does), a fans launch clips each against the guard planes and fans it
(``guard_clip_xy``'s arithmetic), and a fixup launch kills the
originals and sets up the pieces.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .binning import (ATTR_FIELDS, VIS_FIELDS, build_attr_fields,
                      build_tri_fields)
from .geometry import FAN_PIECES, clip_near, guard_clip_xy, setup_triangles
from ..math import transforms

# Launch count of each of the kernel's three launches; the wrapper adds
# one per launch (a graph's replay runs its captured launches uncounted).
LAUNCHES = {"setup_tables": 0, "setup_fans": 0, "setup_fixup": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class PassGeometry:
    """Post-clip, per-pass triangle data consumed by the raster kernels."""

    vattrs: torch.Tensor     # f32[T_clipped, 3, 8] world | uv | normal
    mat_kind: torch.Tensor   # i32[T_clipped]
    mat_color: torch.Tensor  # f32[T_clipped, 3]
    tex_id: torch.Tensor     # i32[T_clipped]
    normal_map_id: torch.Tensor  # i32[T_clipped]


@dataclasses.dataclass(frozen=True)
class MainTables:
    """The main pass's per-slot tables. ``bin_triangles`` takes it as its
    setup (it reads ``valid`` and ``aabb``)."""

    vis: torch.Tensor        # f32[S, 17] visibility fields
    attr: torch.Tensor       # f32[S, 48] per-vertex value/w
    aabb: torch.Tensor       # f32[S, 4] (xmin, ymin, xmax, ymax)
    valid: torch.Tensor      # bool[S]
    stats: dict              # culled_triangles, xyclip_*, max_screen_coord


def prepare_main_pass(geom, vp, config):
    """Project (``vp``: the camera's P @ V, f32[4,4] on the geometry's
    device), near-clip, x/y guard-band clip (all with attribute
    interpolation) and set up triangles for the camera pass: (setup,
    PassGeometry, the pass's prep stats)."""
    clip = transforms.transform_points(vp, geom.world).reshape(-1, 3, 4)
    attrs = torch.cat([geom.world, geom.uvs, geom.normals],
                      dim=-1).reshape(-1, 3, 8)
    clip2, attrs2, parent = clip_near(clip, attrs)
    if config.xyclip_capacity > 0:
        clip2, attrs2, parent, gstats = guard_clip_xy(
            clip2, attrs2, parent, config.width, config.height,
            cap=config.xyclip_capacity, guard_px=config.guard_band_px)
    else:
        zero = torch.zeros((), dtype=torch.int32, device=clip.device)
        gstats = {"xyclip_triangles": zero, "xyclip_dropped": zero}
    setup = setup_triangles(
        clip2, config.width, config.height,
        cull_backfaces=config.cull_backfaces, near_eps=config.near_eps,
    )
    p = parent.to(torch.int64)
    pg = PassGeometry(
        vattrs=attrs2,
        mat_kind=geom.mat_kind[p],
        mat_color=geom.mat_color[p],
        tex_id=geom.tex_id[p],
        normal_map_id=geom.normal_map_id[p],
    )
    return setup, pg, {
        "culled_triangles": (~setup.valid).sum().to(torch.int32),
        **gstats,
        "max_screen_coord": torch.amax(
            torch.where(setup.valid[:, None, None], torch.abs(setup.screen),
                        torch.zeros_like(setup.screen))),
    }


def main_pass_tables_plain(geom, vp, config) -> MainTables:
    """Plain PyTorch twin of the kernel: the eager chain."""
    setup, pg, stats = prepare_main_pass(geom, vp, config)
    return MainTables(vis=build_tri_fields(setup),
                      attr=build_attr_fields(setup, pg), aabb=setup.aabb,
                      valid=setup.valid, stats=stats)


class _Args(ctypes.Structure):
    """csrc/setup.cu ``SetupArgs``."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "world", "uvs", "normals", "mat_kind", "mat_color", "tex_id", "nmid",
        "vp", "vis", "attr", "aabb", "valid", "keys", "counters", "ids",
        "fan")]
        + [(k, ctypes.c_int) for k in ("n_tris", "cap", "cull")]
        + [(k, ctypes.c_float) for k in ("half_w", "half_h", "near_eps",
                                         "gx", "gy")])


@functools.cache
def _lib():
    lib = _build.load_library()
    for name in ("mr_setup_tables", "mr_setup_fans", "mr_setup_fixup"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name, args, device):
    err = getattr(_lib(), "mr_" + name)(ctypes.byref(args),
                                        _build.stream(device))
    _build.raise_on(err, name)
    LAUNCHES[name] += 1


def main_pass_tables(geom, vp, config) -> MainTables:
    """The main pass's tables and stats from the baked geometry ``geom``
    (a ``PackedGeometry``) and the camera's P @ V ``vp`` f32[4, 4] on its
    device. CPU (and meta) tensors go to the plain twin; CUDA tensors
    launch the kernel, and a failed launch raises. On the card it neither
    syncs nor uploads, so a prep graph captures it."""
    if geom.world.device.type != "cuda":
        return main_pass_tables_plain(geom, vp, config)
    return _main_pass_tables_kernel(geom, vp, config)


def _main_pass_tables_kernel(geom, vp, config) -> MainTables:
    """``main_pass_tables`` through the kernel's three launches."""
    device = geom.world.device
    n = geom.num_triangles
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("world", geom.world, f32, (3 * n, 3)),
            ("uvs", geom.uvs, f32, (3 * n, 2)),
            ("normals", geom.normals, f32, (3 * n, 3)),
            ("mat_kind", geom.mat_kind, i32, (n,)),
            ("mat_color", geom.mat_color, f32, (n, 3)),
            ("tex_id", geom.tex_id, i32, (n,)),
            ("normal_map_id", geom.normal_map_id, i32, (n,)),
            ("vp", vp, f32, (4, 4))):
        _build.check(name, t, dtype, device, shape)
    cap = min(config.xyclip_capacity, 2 * n) if config.xyclip_capacity > 0 \
        else 0
    slots = 2 * n + FAN_PIECES * cap
    vis = torch.empty((slots, VIS_FIELDS), dtype=f32, device=device)
    attr = torch.empty((slots, ATTR_FIELDS), dtype=f32, device=device)
    aabb = torch.empty((slots, 4), dtype=f32, device=device)
    valid = torch.empty((slots,), dtype=torch.bool, device=device)
    # Invalid slots, the largest |screen| coordinate's bits, oversize slots.
    counters = torch.zeros((3,), dtype=i32, device=device)
    keys = (torch.empty((2 * n,), dtype=torch.uint8, device=device)
            if cap else None)
    gx = 2.0 * config.guard_band_px / float(config.width)
    gy = 2.0 * config.guard_band_px / float(config.height)
    p = _build.ptr
    args = _Args(p(geom.world), p(geom.uvs), p(geom.normals),
                 p(geom.mat_kind), p(geom.mat_color), p(geom.tex_id),
                 p(geom.normal_map_id), p(vp), p(vis), p(attr), p(aabb),
                 p(valid), p(keys), p(counters), p(None), p(None),
                 n, cap, int(config.cull_backfaces), 0.5 * config.width,
                 0.5 * config.height, config.near_eps, gx, gy)
    _launch("setup_tables", args, device)
    if cap:
        # guard_clip_xy's side list: the first cap slots of the stable
        # sort of the keys (oversize first, each group in slot order).
        ids = torch.sort(keys, stable=True).indices[:cap]
        fan = torch.empty((FAN_PIECES * cap, 3, 12), dtype=f32,
                          device=device)
        args.ids, args.fan = p(ids).value, p(fan).value
        _launch("setup_fans", args, device)
        _launch("setup_fixup", args, device)
        n_over = counters[2].to(torch.int64)
        gstats = {"xyclip_triangles": torch.clamp_max(n_over, cap),
                  "xyclip_dropped": torch.clamp_min(n_over - cap, 0)}
    else:
        zero = torch.zeros((), dtype=i32, device=device)
        gstats = {"xyclip_triangles": zero, "xyclip_dropped": zero}
    stats = {"culled_triangles": counters[0], **gstats,
             "max_screen_coord": counters[1:2].view(f32)[0]}
    return MainTables(vis=vis, attr=attr, aabb=aabb, valid=valid,
                      stats=stats)
