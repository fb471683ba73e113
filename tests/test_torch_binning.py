"""Port parity, binning: the port's CSR tile lists and big list against what
is decoded from the JAX ``TileBins`` built from the same triangle setup.

Everything compared here is integer and must be equal: each tile's
ordered triangle-id list (the JAX chunks' valid and tid lane groups,
binning.py:38-45), the big list (live-first by tid), its AABBs, ``big_n``
and ``num_big_dropped``. The field tables are compared as in
test_torch_geometry (float tolerance scaled to the table's magnitude).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalrenderer_tpu.config import RenderConfig as JConfig
from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.passes import pipeline as j_pipe
from metalrenderer_tpu.raster import binning as jb
from metalrenderer_tpu.raster.geometry import setup_triangles
from metalrenderer_tpu.scene.camera import OrbitCamera as JCamera
from metalrenderer_tpu.scene.scene import bake

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.raster import binning

torch.set_num_threads(2)


def _soup(n, seed, big_every=0):
    """Clip-space soup; every ``big_every``-th triangle spans the screen."""
    rng = np.random.default_rng(seed)
    tris = []
    for i in range(n):
        c = rng.uniform(-0.9, 0.9, 2)
        sc = rng.uniform(1.5, 2.5) if big_every and i % big_every == 0 \
            else rng.uniform(0.02, 0.4)
        pts = c + sc * np.array([[0, 0], [1, 0.1], [0.3, 1]]) * \
            rng.uniform(0.5, 1.5, (3, 2))
        d1, d2 = pts[1] - pts[0], pts[2] - pts[0]
        if d1[0] * d2[1] - d1[1] * d2[0] < 0:
            pts = pts[::-1]
        z, w = rng.uniform(0.05, 0.95), rng.uniform(0.5, 3)
        tris.append([[p[0] * w, p[1] * w, z * w, w] for p in pts])
    return jnp.asarray(np.asarray(tris, np.float32))


_setup = jax.jit(setup_triangles, static_argnums=(1, 2, 3))


def _decode_tile_lists(jbins, ntx, nty):
    """Per-tile tid lists from the JAX chunk layout."""
    chunks = np.asarray(jbins.chunks)
    sub4 = np.asarray(jbins.sub4_of_chunk).astype(np.uint32)
    sub = np.stack([(sub4 >> (8 * k)) & 0xFF for k in range(4)],
                   axis=1).reshape(-1)
    band_start = np.asarray(jbins.band_start)
    band_end = np.asarray(jbins.band_end)
    C = jb.CHUNK
    lists = [[] for _ in range(ntx * nty)]
    for b in range(nty):
        for ci in range(band_start[b], band_end[b]):
            valid = chunks[ci, 2, 7 * C:8 * C]
            tid = chunks[ci, 2, 8 * C:9 * C]
            lists[b * ntx + int(sub[ci])] += [int(t) for t in tid[valid > 0]]
    return lists


def _port_tile_lists(bins):
    off = bins.tile_offsets.numpy()
    tris = bins.tile_tris.numpy()
    return [list(map(int, tris[off[t]:off[t + 1]]))
            for t in range(bins.ntx * bins.nty)]


def _compare(setup_j, width, height, tile_w, tile_h, span_cap=8,
             big_capacity=256):
    fields_j = jax.jit(jb.build_tri_fields)(setup_j)
    jbins = jax.jit(jb.bin_triangles, static_argnums=(2, 3, 4, 5, 6, 7))(
        setup_j, fields_j, width, height, tile_w, tile_h, span_cap,
        big_capacity)
    setup_p = convert.setup_from_jax(setup_j)
    fields_p = binning.build_tri_fields(setup_p)
    ref = np.asarray(fields_j)
    np.testing.assert_allclose(fields_p.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    bins = binning.bin_triangles(setup_p, convert.tensor(fields_j), width,
                                 height, tile_w, tile_h, span_cap=span_cap,
                                 big_capacity=big_capacity)
    assert _port_tile_lists(bins) == _decode_tile_lists(jbins, bins.ntx,
                                                        bins.nty)
    n = int(jbins.big_n[0])
    assert int(bins.big_n[0]) == n
    assert int(bins.num_big_dropped) == int(jbins.num_big_dropped)
    big_tri = np.asarray(jbins.big_tri).reshape(-1, jb.VIS_FIELDS)
    np.testing.assert_array_equal(bins.big_ids.numpy()[:n],
                                  big_tri[:n, 16].astype(np.int32))
    np.testing.assert_array_equal(
        bins.big_aabb.numpy()[:n],
        np.asarray(jbins.big_tri_aabb).reshape(-1, 4)[:n])
    return bins


def test_soup_tile_lists_match():
    setup = _setup(_soup(120, seed=1, big_every=15), 256, 128)
    bins = _compare(setup, 256, 128, 128, 8)
    assert int(bins.big_n[0]) > 0
    assert sum(len(x) for x in _port_tile_lists(bins)) > 120


def test_big_list_overflow_matches():
    """More big triangles than ``big_capacity``: both keep the first
    ``big_capacity`` live ones by tid and count the rest."""
    setup = _setup(_soup(60, seed=2, big_every=4), 256, 128)
    bins = _compare(setup, 256, 128, 128, 8, big_capacity=3)
    assert int(bins.big_n[0]) == 3
    assert int(bins.num_big_dropped) > 0


def _flagship_setups(width, height, shadow_size):
    cfg = JConfig(width=width, height=height, msaa=4,
                  shadow_map_size=shadow_size)
    cam = JCamera(radius=5.0, theta=2.5, phi=1.2, aspect=width / height)
    geom = bake(j_app.build_scene(), 0.02)
    prep = jax.jit(j_pipe.prepare_main_pass, static_argnums=(3,))
    setup, _ = prep(geom, cam.view_matrix(), cam.projection_matrix(), cfg)
    return setup


@pytest.mark.parametrize("size", [(96, 72), (320, 240)])
def test_flagship_main_pass_lists_match(size):
    bins = _compare(_flagship_setups(*size, 128), *size, 128, 8)
    # The floor spans more than span_cap tiles once the frame is wide.
    assert (int(bins.big_n[0]) > 0) == (size[0] > 128)


def test_non_tile_aligned_shadow_tiles_match():
    setup = _setup(_soup(80, seed=9, big_every=10), 200, 150, False)
    _compare(setup, 200, 150, 128, 64)
