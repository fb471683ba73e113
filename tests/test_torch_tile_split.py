"""Port parity, the split tile walk of K2/K6 and K3/K5 (``csrc/raster.cu``;
``raster_cuda``'s module doc): a tile whose list and live big list hold
more than L candidates is walked in slices of L, each from
``(clear_depth, -1)``, and the slices' per-sample winners are merged with
take. The twins carry the same split as an option (``split``,
``merge_order``). Held here, bit for bit (depth bits, winners, gout, rgba),
against the twins' default walk:

  * a seeded crowd tile of ~600 candidates (``chip_smoke.fused_soup_bins``:
    exact duplicates, whose ties go to the larger tid, and z-fighting
    partners) with a big list, at L = 1, 2 and 3 staging chunks, the slice
    boundary at 512 inside the tile's big-list entries, slices merged in
    order, reversed and permuted;
  * candidates at exactly ``clear_depth`` (they win over the clear value);
  * depth planes that evaluate to -0.0 beside +0.0 (equal under take: the
    larger tid wins and keeps its own sign bit);

and against the JAX package: the split twin's winners equal to the
interpret-mode Pallas kernel's on a crowd tile at 64x16, depth within
1e-6 (XLA:CPU contracts FMAs, ROADMAP C6). The split plan's bounds
(``split_plan``, from shapes alone) hold what the lists need. On a CUDA
device (``-m cuda``), K2, K3, K5 and K6 against their default twins on a
tile of ~10,000 candidates and on the crafted tiles.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.raster import binning as jb
from metalrenderer_tpu.raster import raster_pallas
from metalrenderer_tpu.raster.geometry import setup_triangles

from chip_smoke import candidate_counts, fused_soup_bins

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.raster import binning, raster_cuda

torch.set_num_threads(2)
MSAA4 = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))
CHUNK = raster_cuda.FUSED_STAGING_CHUNK
W, H = 256, 40              # 2 x 5 tiles of 8x128


@functools.cache
def _crowd():
    """The crowd soup: its longest list (494 entries) and 82 gated big-list
    entries in one tile, 576 candidates."""
    return fused_soup_bins(W, H, seed=7, device="cpu", crowd=340, small=40,
                           big=250)


def _uniforms():
    """Fused-shade uniforms (``raster_cuda.FU_*``): no shadow matrix, a
    camera and a light above the scene, Blinn-Phong at 32, a clear color."""
    u = torch.zeros(raster_cuda.FU_LEN)
    u[raster_cuda.FU_CAM:raster_cuda.FU_CAM + 3] = torch.tensor([0.3, 2.0,
                                                                 4.0])
    u[raster_cuda.FU_LPOS:raster_cuda.FU_LPOS + 3] = torch.tensor([1.0, 3.0,
                                                                   1.0])
    u[raster_cuda.FU_LCOL:raster_cuda.FU_LCOL + 3] = torch.tensor([1.0, 0.9,
                                                                   0.8])
    u[raster_cuda.FU_AMB] = 0.1
    u[raster_cuda.FU_SHIN] = 32.0
    u[raster_cuda.FU_CLEAR:raster_cuda.FU_CLEAR + 4] = torch.tensor(
        [0.1, 0.1, 0.15, 1.0])
    u[raster_cuda.FU_BIAS] = 0.005
    u[raster_cuda.FU_FACTOR] = 0.3
    return u


def _run(kind, bins, width, height, samples, clear_depth=1.0, **split):
    """The twin of ``kind`` (``gbuffer``: gout, depth, winner; ``fused``:
    rgba, covered fraction) on ``bins``, with the split walk's options."""
    if kind == "gbuffer":
        return raster_cuda.raster_gbuffer_plain(
            bins, width, height, samples, clear_depth, with_samples=True,
            **split)
    return raster_cuda.render_fused_plain(bins, _uniforms(), None, width,
                                          height, samples, clear_depth,
                                          **split)


@functools.cache
def _walk(kind, clear_depth=1.0):
    return _run(kind, _crowd(), W, H, MSAA4, clear_depth)


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _order(name):
    if name == "in order":
        return None
    if name == "reversed":
        return lambda n: list(range(n))[::-1]
    return lambda n: list(np.random.default_rng(n).permutation(n))


def _longest(bins):
    """(tile, list entries, gated big-list entries) of the longest list."""
    off = bins.tile_offsets.to(torch.int64)
    per = off[1:] - off[:-1]
    t = int(torch.argmax(per))
    cand = raster_cuda._staging_order(bins, torch.tensor([t],
                                                         device=off.device))
    return t, int(per[t]), int((cand[0, int(per[t]):] >= 0).sum())


def test_crowd_tile_shape():
    """The crowd tile holds what the split must get right: ~600
    candidates, the slice boundary at 512 among its big-list entries,
    exact duplicates and z-fighting partners."""
    bins = _crowd()
    _, n_list, n_big = _longest(bins)
    assert (n_list, n_big) == (494, 82)
    assert n_list < 2 * CHUNK < n_list + n_big
    assert int(bins.num_big_dropped) == 0
    rows = bins.vis[:, :15]
    assert torch.unique(rows, dim=0).shape[0] < rows.shape[0]
    for kind in ("gbuffer", "fused"):
        covered = _walk(kind)[0 if kind == "gbuffer" else 1]
        assert float((covered[binning.ROW_DEPTH] > 0 if kind == "gbuffer"
                      else covered > 0).float().mean()) > 0.9


@pytest.mark.parametrize("kind", ["gbuffer", "fused"])
@pytest.mark.parametrize("chunks,order", [
    (1, "reversed"), (1, "permuted"), (2, "permuted"), (3, "in order")])
def test_split_twin_matches_walk(kind, chunks, order):
    """Slices of 1, 2 or 3 chunks (3: the tile fits one slice, the walk as
    before), merged in any order: bit-equal to the walk of all candidates."""
    out = _run(kind, _crowd(), W, H, MSAA4, split=chunks * CHUNK,
               merge_order=_order(order))
    assert _bits_equal(out, _walk(kind))


def test_split_twin_rejects_a_partial_order():
    with pytest.raises(ValueError, match="merge_order"):
        _run("gbuffer", _crowd(), W, H, MSAA4, split=CHUNK,
             merge_order=lambda n: [0])


def _crafted_bins(zs, n_big=0, seed=0):
    """One 128x8 tile whose candidates cover all of it: edges (0, 0, 1),
    depth planes (a, b, c) = (z, z, z) for z = +-0.0 (every anchored
    evaluation of them keeps z's sign) and (0, 0, z) otherwise; the last
    ``n_big`` of them on the big list (an AABB over the tile), the rest on
    the tile's list; random attribute rows."""
    n = len(zs)
    vis = torch.zeros(n, 17)
    vis[:, [2, 5, 8]] = 1.0
    z = torch.tensor(zs, dtype=torch.float32)
    zero = z == 0.0
    vis[:, 9] = torch.where(zero, z, torch.zeros_like(z))
    vis[:, 10] = vis[:, 9]
    vis[:, 11] = z
    vis[:, 12:15] = 1.0
    vis[:, 15] = 1.0
    vis[:, 16] = torch.arange(n, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    attr = torch.from_numpy(rng.uniform(0.1, 1.0, (n, 48)).astype(np.float32))
    n_list = n - n_big
    cap = max(n_big, 1)
    big_ids = torch.zeros(cap, dtype=torch.int32)
    big_ids[:n_big] = torch.arange(n_list, n, dtype=torch.int32)
    big_aabb = torch.zeros((cap, 4), dtype=torch.int32)
    big_aabb[:n_big] = torch.tensor([0, 0, 128, 8], dtype=torch.int32)
    return binning.TileBins(
        tile_w=128, tile_h=8, ntx=1, nty=1, vis=vis, attr=attr,
        tile_offsets=torch.tensor([0, n_list], dtype=torch.int32),
        tile_tris=torch.arange(n_list, dtype=torch.int32),
        big_ids=big_ids, big_aabb=big_aabb,
        big_n=torch.tensor([n_big], dtype=torch.int32),
        num_big_dropped=torch.zeros((), dtype=torch.int32))


def _clear_depth_case():
    """600 candidates at depths 0.8 and 0.9 (behind the clear depth 0.75),
    and at exactly 0.75 (tids 37, 301 and 470: 470 is past the first slice
    and in the big list)."""
    zs = [0.8 if i % 2 else 0.9 for i in range(600)]
    for t in (37, 301, 470):
        zs[t] = 0.75
    return _crafted_bins(zs, n_big=150), 0.75, 470


def _negative_zero_case(winner_sign):
    """600 candidates at depth 0.5, with -0.0 at tids 10 and 300 and +0.0
    at 200 and 520 (520 in the big list); the largest zero's tid wins,
    -0.0 (tid 560) or +0.0 (tid 520) as ``winner_sign`` asks."""
    zs = [0.5] * 600
    zs[10] = zs[300] = -0.0
    zs[200] = zs[520] = 0.0
    if winner_sign < 0:
        zs[560] = -0.0
    return _crafted_bins(zs, n_big=200), 1.0, 560 if winner_sign < 0 else 520


@pytest.mark.parametrize("kind", ["gbuffer", "fused"])
@pytest.mark.parametrize("case", ["clear_depth", "negative_zero",
                                  "positive_zero"])
def test_split_twin_ties(kind, case):
    """Candidates at exactly clear_depth win over the clear value; -0.0
    ties +0.0 and the larger tid wins with its own sign bit. The split
    walk (1 and 2 chunks, reversed) keeps every bit of the walk's result."""
    if case == "clear_depth":
        bins, clear, want = _clear_depth_case()
    else:
        bins, clear, want = _negative_zero_case(
            -1 if case == "negative_zero" else 1)
    ref = _run(kind, bins, 128, 8, MSAA4, clear)
    if kind == "gbuffer":
        _, depth, winner = ref
        assert bool((winner == want).all())
        want_z = torch.tensor(-0.0 if case == "negative_zero" else
                              0.0 if case == "positive_zero" else clear)
        assert bool((depth.view(torch.int32)
                     == want_z.view(torch.int32)).all())
    for chunks in (1, 2):
        out = _run(kind, bins, 128, 8, MSAA4, clear, split=chunks * CHUNK,
                   merge_order=_order("reversed"))
        assert _bits_equal(out, ref)


def test_split_twin_matches_pallas():
    """The JAX package on the same inputs: a crowd tile of ~620 candidates
    (exact duplicates, no other coplanar pairs) at 64x16, through the
    interpret-mode Pallas kernel and the port's split twin (slices of one
    chunk) on the JAX setup's own field tables: winners equal, depth
    within 1e-6."""
    rng = np.random.default_rng(5)
    w, h, n = 64, 16, 500
    c = np.stack([rng.uniform(0, w, n), rng.uniform(0, 8, n)], -1)
    ext = rng.uniform(0.3, 1.0, (n, 1, 2)) * np.array([10.0, 3.0])
    pts = c[:, None] + ext * rng.uniform(-1, 1, (n, 3, 2))
    ndc = np.stack([pts[..., 0] * (2.0 / w) - 1.0,
                    1.0 - pts[..., 1] * (2.0 / h)], -1)
    z = rng.uniform(0.02, 0.98, (n, 1)) + rng.uniform(-0.02, 0.02, (n, 3))
    wc = rng.uniform(0.5, 3.0, (n, 1)) * rng.uniform(0.9, 1.1, (n, 3))
    clip = np.concatenate([ndc * wc[..., None], (z * wc)[..., None],
                           wc[..., None]], -1)
    clip = np.concatenate([clip, clip[::4]]).astype(np.float32)
    setup_j = setup_triangles(jnp.asarray(clip), w, h, cull_backfaces=False)
    d_j, w_j, _, _ = raster_pallas.rasterize_tiles(setup_j, w, h, 8, 128,
                                                   MSAA4)
    fields = convert.tensor(jb.build_tri_fields(setup_j))
    bins = binning.bin_triangles(
        convert.setup_from_jax(setup_j), fields, w, h, 128, 8,
        attr_fields=torch.zeros((fields.shape[0], 48)))
    assert _longest(bins)[1] > 2 * CHUNK
    _, d_p, w_p = _run("gbuffer", bins, w, h, MSAA4, split=CHUNK,
                       merge_order=_order("permuted"))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)
    assert 0.3 < float((w_p >= 0).float().mean()) < 1.0


def test_split_plan_bounds():
    """``split_plan`` bounds, from the bins' shapes, the split tiles and
    items that ``split_stats`` counts on the lists, per frame and over a
    batch; and is None where no tile can outgrow the threshold."""
    A, L = raster_cuda.TILE_SPLIT_ABOVE, raster_cuda.TILE_SPLIT_SLICE
    crowd = _crowd()
    batch = raster_cuda.stack_bins([crowd, fused_soup_bins(
        W, H, seed=8, device="cpu", crowd=340, small=40, big=250)])
    for bins, frames in ((crowd, 1), (batch, 2),
                         (_clear_depth_case()[0], 1)):
        plan = raster_cuda.split_plan(bins, frames)
        st = raster_cuda.split_stats(bins, 4)
        assert (plan.above, plan.chunks) == (A // CHUNK, L // CHUNK)
        assert 0 < st["split_tiles"] <= plan.tiles
        assert st["items"] <= plan.items and plan.workers <= plan.items
        assert st["merge_key_bytes"] <= st["scratch_bytes"]
    st = raster_cuda.split_stats(crowd, 4)
    assert (st["split_tiles"], st["items"]) == (1, -(-576 // L))
    assert st["merge_key_bytes"] == 4 * 128 * 8 * 8
    assert raster_cuda.split_plan(_crafted_bins([0.5] * 8)) is None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _to(bins, device):
    return binning.TileBins(**{
        k: (v.to(device) if isinstance(v, torch.Tensor) else v)
        for k, v in vars(bins).items()})


@pytest.mark.cuda
def test_split_kernels_match_twins_on_card(cuda_device):
    """K3 and K5 (gout, depth and winners bit-equal) and K2 and K6 (covered
    fractions equal, rgba within 1e-5: the twins' powf and sqrt) against
    their default twins on a tile of ~10,000 candidates, each frame of a
    2-frame batch as the per-frame kernel, and K2/K3 on the crafted ties."""
    w, h = 512, 64
    soups = [fused_soup_bins(w, h, seed=s, device=cuda_device, crowd=8000,
                             small=400, big=200) for s in (21, 22)]
    assert int(candidate_counts(soups[0]).max()) > 9000
    u = _uniforms().to(cuda_device)
    for bins in soups:
        assert _longest(bins)[1] > 8000
        k = raster_cuda.raster_gbuffer(bins, w, h, MSAA4, with_samples=True)
        p = raster_cuda.raster_gbuffer_plain(bins, w, h, MSAA4,
                                             with_samples=True)
        assert _bits_equal(k, p)
        rk, ck = raster_cuda.render_fused(bins, u, None, w, h, MSAA4)
        rp, cp = raster_cuda.render_fused_plain(bins, u, None, w, h, MSAA4)
        assert torch.equal(ck, cp)
        assert float((rk - rp).abs().max()) <= 1e-5
    batch = raster_cuda.stack_bins(soups)
    g_k = raster_cuda.raster_gbuffer_batch(batch, w, h, MSAA4)
    g_p = raster_cuda.raster_gbuffer_batch_plain(batch, w, h, MSAA4)
    assert torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
    u2 = torch.stack([u, u])
    r_k, c_k = raster_cuda.render_fused_batch(batch, u2, None, w, h, MSAA4)
    r_p, c_p = raster_cuda.render_fused_batch_plain(batch, u2, None, w, h,
                                                    MSAA4)
    assert torch.equal(c_k, c_p)
    assert float((r_k - r_p).abs().max()) <= 1e-5
    for f in range(2):
        r_1, _ = raster_cuda.render_fused(raster_cuda.frame_bins(batch, f),
                                          u, None, w, h, MSAA4)
        assert torch.equal(r_k[f], r_1)
    for bins, clear, _ in (_clear_depth_case(), _negative_zero_case(-1),
                           _negative_zero_case(1)):
        bins = _to(bins, cuda_device)
        k = raster_cuda.raster_gbuffer(bins, 128, 8, MSAA4, clear,
                                       with_samples=True)
        p = raster_cuda.raster_gbuffer_plain(bins, 128, 8, MSAA4, clear,
                                             with_samples=True)
        assert _bits_equal(k, p)
        rk, ck = raster_cuda.render_fused(bins, u, None, 128, 8, MSAA4,
                                          clear)
        rp, cp = raster_cuda.render_fused_plain(bins, u, None, 128, 8, MSAA4,
                                                clear)
        assert torch.equal(ck, cp)
        assert float((rk - rp).abs().max()) <= 1e-5
    torch.cuda.synchronize()
