"""The audio track's carries as kernels (``csrc/track.cu``) and the track
as one CUDA graph per chunk shape (``audio.track.TRACK_GRAPH``).

On the CPU: the carries' and the envelope's packed entry points
(``analyzer.carries``, ``mapping.envelope``: the kernels' twins) bit-equal
to the numpy loops over seeded states, the ring empty, filling, full and
wrapping at 120, for 1, 8 and 300 chunks; the packed states' round trip;
``track.run`` bit-equal to the public op-by-op pipeline; the track's body
with no op a capture refuses (no host data made a tensor, no sync, only
meta tensors on the meta device); the copy that keeps a graph's output
apart from the next replay, on a CPU stand-in for the graph.

On the card (``-m cuda``): both kernels bit-equal to their twins; the
graphed track bit-equal to the op-by-op track over a 40-chunk stream at 1
and 8 chunks a call, every output and both states; the capture at a
shape's second call and replays after; a returned tensor unchanged by the
next replay.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_prep_graph import _HostTraffic, _OffDevice

from metalrenderer_tpu_torch.audio import (analyzer, interpreter, mapping,
                                           track)

SR = 48000.0
N = analyzer.FFT_SIZE
W = analyzer.ROLLING_WINDOW


def _signal(chunks, seed=0):
    """Tones at a few levels, noise and silence: chunk-sized parts."""
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    parts = []
    for k in range(chunks):
        kind = k % 4
        if kind == 0:
            parts.append(0.006 * np.sin(2 * np.pi * 440.0 * t))
        elif kind == 1:
            parts.append(0.0045 * np.sin(2 * np.pi * 220.0 * t + k))
        elif kind == 2:
            parts.append(rng.normal(0.0, 0.0015, N))
        else:
            parts.append(np.zeros(N))
    return np.concatenate(parts).astype(np.float32)


def _state(rng, count, idx=0):
    """A seeded analyzer state with ``count`` ring entries filled."""
    f32 = np.float32
    return analyzer.AnalyzerState(
        rolling=torch.from_numpy(rng.random(W, dtype=f32) * f32(0.01)),
        rolling_idx=torch.tensor(idx, dtype=torch.int32),
        rolling_count=torch.tensor(count, dtype=torch.int32),
        rolling_sum=torch.tensor(rng.random(dtype=f32) * f32(0.5)),
        smoothed_bass=torch.tensor(rng.random(dtype=f32)),
        smoothed_mid=torch.tensor(rng.random(dtype=f32)),
        smoothed_treble=torch.tensor(rng.random(dtype=f32)))


def _scalars(rng, n):
    return torch.from_numpy(rng.random((n, 4), dtype=np.float32)
                            * np.float32(0.02))


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.int32)


def _same(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a.cpu()), _bits(b.cpu())))


# The ring empty, part filled, one short of full, full at its first slot
# and full about to wrap.
RINGS = [(0, 0), (37, 0), (W - 1, 0), (W, 0), (W, W - 1)]


@pytest.mark.parametrize("n", [1, 8, 300])
@pytest.mark.parametrize("count,idx", RINGS)
def test_carries_twin_is_the_numpy_loop(n, count, idx):
    rng = np.random.default_rng(1000 * n + count + idx)
    state = _state(rng, count, idx)
    scalars = _scalars(rng, n)
    vec, carried = analyzer.carries(state.pack(), scalars)
    want, avg, smoothed = analyzer._carries(
        state, scalars[:, 0].numpy(), scalars[:, 1:].numpy())
    assert vec.shape == (analyzer.STATE_LEN,) and carried.shape == (n, 4)
    assert _same(vec, want.pack())
    assert _same(carried[:, 0], torch.from_numpy(avg))
    assert _same(carried[:, 1:], torch.from_numpy(smoothed))
    # The ring holds the last pushes: appended until full, then written
    # round-robin from its write slot.
    got = analyzer.AnalyzerState.unpack(vec)
    assert int(got.rolling_count) == min(count + n, W)
    first = idx if count == W else count
    last = {(first + k) % W: k for k in range(n)}
    for slot, k in last.items():
        assert got.rolling[slot] == scalars[k, 0]


@pytest.mark.parametrize("n", [1, 8, 300])
def test_envelope_twin_is_the_numpy_loop(n):
    rng = np.random.default_rng(n)
    raw = torch.from_numpy(rng.random(n, dtype=np.float32))
    raw[::3] = 0.0                       # decays between the peaks
    start = torch.tensor([0.3], dtype=torch.float32)
    env = mapping.envelope(start, raw)
    want = mapping._envelope(0.3, raw.numpy())
    assert env.shape == (n + 1,) and _same(env[:1], start)
    assert _same(env[1:], torch.from_numpy(want))


def test_packed_states_round_trip():
    state = _state(np.random.default_rng(7), W, 42)
    vec = state.pack()
    assert vec.dtype == torch.float32 and vec.shape == (analyzer.STATE_LEN,)
    back = analyzer.AnalyzerState.unpack(vec)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    up = track.upload(torch.ones(2 * N), state, mapping.VisualState.init())
    assert up.shape == (2 * N + track.STATE_LEN,)
    assert _same(up[2 * N:-1], vec) and float(up[-1]) == np.float32(0.3)


def _public_pipeline(samples, a_state, v_state):
    """The op-by-op track through the public entry points."""
    a_state, res = analyzer.analyze_stream(samples, SR, a_state,
                                           device="cpu")
    ctx = interpreter.interpret(res, SR)
    v_state, params = mapping.map_audio_to_visual(v_state, ctx, res.rms,
                                                  res.rolling_avg)
    return a_state, v_state, params, ctx


def _assert_same_track(got, want):
    (a1, v1, p1, c1), (a2, v2, p2, c2) = got, want
    for x, y in ((a1, a2), (v1, v2), (p1, p2), (c1, c2)):
        for f in dataclasses.fields(x):
            u, w = getattr(x, f.name), getattr(y, f.name)
            assert _same(torch.as_tensor(u), torch.as_tensor(w)), f.name


def test_run_is_the_public_pipeline():
    """``track.run`` on the CPU, call after call from carried states (the
    second call fills the ring past its wrap), equals the public op-by-op
    pipeline bit for bit."""
    sig = _signal(130)
    states = (analyzer.AnalyzerState.init(), mapping.VisualState.init())
    mine = states
    for lo, hi in ((0, 3), (3, 130)):
        block = sig[lo * N:hi * N]
        got = track.run(block, SR, *mine[:2], torch.device("cpu"))
        want = _public_pipeline(block, *states[:2])
        _assert_same_track(got, want)
        mine, states = got, want


def _kernel_stand_ins(monkeypatch):
    """The carries as the card runs them, for a capture check: device ops
    alone (the numpy twins are the CPU's own path)."""
    def carries(state, scalars):
        return state * 1.0, scalars * 1.0

    def envelope(start, raw):
        return torch.cat([start, raw])
    monkeypatch.setattr(analyzer, "carries", carries)
    monkeypatch.setattr(mapping, "envelope", envelope)


@pytest.mark.parametrize("n", [1, 8])
def test_track_body_makes_no_op_a_capture_refuses(monkeypatch, n):
    """The track's body (kernels stood in for) makes no op that syncs or
    brings host data up, and on the meta device takes no host tensor: the
    constants come from ``analyzer.constants``, made before."""
    _kernel_stand_ins(monkeypatch)
    up = track.upload(torch.from_numpy(_signal(n)),
                      analyzer.AnalyzerState.init(),
                      mapping.VisualState.init())
    for dev, mode in (("cpu", _HostTraffic), ("meta", _OffDevice)):
        inp = up.to(dev)
        analyzer.constants(dev, SR)          # made once, outside
        with mode() as traffic:
            out = track.body(inp, n, SR)
        assert traffic.found == [], dev
        assert out.shape == (track.STATE_LEN + n * track.FRAME_LEN,)


def test_run_copies_a_graphs_output(monkeypatch):
    """Where the graph hands ``run`` its static output, the caller gets a
    copy that the next replay leaves alone."""
    sig = _signal(4)
    dev = torch.device("cpu")
    a0, v0 = analyzer.AnalyzerState.init(), mapping.VisualState.init()
    outs = [track.body(track.upload(torch.from_numpy(sig[k * N:(k + 1) * N]),
                                    a0, v0), 1, SR) for k in range(3)]
    static = outs[0].clone()

    def replay(up, n, sample_rate, device):
        static.copy_(outs.pop(0))
        return static
    monkeypatch.setattr(track, "_graphed", replay)
    first = track.run(sig[:N], SR, a0, v0, dev)
    kept = [t.clone() for t in (first[2].light_color, first[3].energy,
                                first[0].rolling, first[1]
                                .brightness_envelope)]
    track.run(sig[N:2 * N], SR, a0, v0, dev)
    now = (first[2].light_color, first[3].energy, first[0].rolling,
           first[1].brightness_envelope)
    assert all(torch.equal(a, b) for a, b in zip(kept, now))
    assert (first[2].light_color.untyped_storage().data_ptr()
            != static.untyped_storage().data_ptr())


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the carries kernels, the graph)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 300])
def test_track_kernels_are_bit_equal_to_their_twins(cuda_device, n):
    from metalrenderer_tpu_torch.audio import track_cuda
    before = dict(track_cuda.LAUNCHES)
    for count, idx in RINGS:
        rng = np.random.default_rng(1000 * n + count + idx)
        vec = _state(rng, count, idx).pack()
        scalars = _scalars(rng, n)
        want = analyzer.carries(vec, scalars)
        got = analyzer.carries(vec.to(cuda_device), scalars.to(cuda_device))
        assert all(_same(a, b) for a, b in zip(got, want)), (count, idx)
    raw = torch.from_numpy(np.random.default_rng(n).random(
        n, dtype=np.float32))
    raw[::3] = 0.0
    start = torch.tensor([0.7], dtype=torch.float32)
    assert _same(mapping.envelope(start.to(cuda_device),
                                  raw.to(cuda_device)),
                 mapping.envelope(start, raw))
    assert track_cuda.LAUNCHES["track_carries"] == \
        before["track_carries"] + len(RINGS)
    assert track_cuda.LAUNCHES["track_envelope"] == \
        before["track_envelope"] + 1


def _stream(sig, chunk, device):
    """The track over ``sig`` in calls of ``chunk`` chunks, from fresh
    states: every call's outputs."""
    a, v = analyzer.AnalyzerState.init(), mapping.VisualState.init()
    calls = []
    for lo in range(0, sig.shape[0] // N, chunk):
        a, v, p, c = track.run(sig[lo * N:(lo + chunk) * N], SR, a, v,
                               device)
        calls.append((a, v, p, c))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 8])
def test_graphed_track_is_bit_equal_on_card(cuda_device, chunk,
                                            monkeypatch):
    """A 40-chunk stream through the graph (op by op at the first call,
    captured at the second, replayed after) equals the op-by-op track on
    the card, every output and both states, call by call, each read after
    the whole stream: a returned tensor is unchanged by later replays."""
    sig = _signal(40, seed=chunk)
    track.TRACK_GRAPH.clear()
    captures, replays = track.TRACK_GRAPH.captures, track.TRACK_GRAPH.replays
    with monkeypatch.context() as m:
        m.setattr(track, "_graphed", lambda *args: None)
        want = _stream(sig, chunk, cuda_device)
    assert track.TRACK_GRAPH.captures == captures
    got = _stream(sig, chunk, cuda_device)
    calls = 40 // chunk
    assert track.TRACK_GRAPH.captures == captures + 1
    assert track.TRACK_GRAPH.replays == replays + calls - 2
    for g, w in zip(got, want):
        _assert_same_track(g, w)
        assert g[2].light_color.device.type == "cpu"
