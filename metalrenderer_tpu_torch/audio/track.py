"""The audio track of a call (analysis, interpretation, mapping) on one
device, from host states to host outputs (``run``, which
``engine.renderer.audio_visual_track`` calls).

The track's device work (``body``) reads one input vector, the call's
samples and both states packed (``upload``), and writes one output
vector, the new states and every frame's ``VisualParams`` and
``MusicalContext`` (``unpack``'s layout). On the card its carries are
kernels (``csrc/track.cu``) and its constants are formed once per device
and sample rate (``analyzer.constants``), so it neither syncs nor uploads:
it is one CUDA graph per chunk shape (``TRACK_GRAPH``), captured at the
shape's second call and replayed after, fed by one pinned upload, and the
output comes to the host in one copy, the call's only read, which is what
the caller gets. At a shape's first call it runs op by op, bit-equal; on
the CPU always.
"""
from __future__ import annotations

import torch

from ..utils.cuda_graphs import GraphCache, capture_graph
from ..utils.profiling import annotate
from . import analyzer, interpreter, mapping
from .analyzer import FFT_SIZE

# The packed states: the analyzer's (``AnalyzerState.pack``), then the
# brightness envelope.
STATE_LEN = analyzer.STATE_LEN + 1
# A frame's output: light color (3), light intensity, displacement, then
# the MusicalContext's energy, brightness, melancholy, dominant pitch and
# pitch confidence.
FRAME_LEN = 10


def upload(samples, a_state, v_state):
    """A call's one input, f32[n * 1024 + STATE_LEN] on the host: the
    chunks' samples (``samples``: f32[n * 1024]), then the packed
    states."""
    return torch.cat([samples.reshape(-1).cpu(), a_state.pack(),
                      torch.as_tensor(v_state.brightness_envelope,
                                      dtype=torch.float32).reshape(1).cpu()])


def body(inp, n, sample_rate):
    """The track's device work on ``inp`` (``upload``'s layout, on the
    device): f32[STATE_LEN + n * FRAME_LEN], the new packed states, then
    each frame's outputs. On the card it neither syncs nor uploads, so a
    track graph captures it whole."""
    chunks = inp[:n * FFT_SIZE].view(n, FFT_SIZE)
    state = inp[n * FFT_SIZE:]
    rms = torch.sqrt(torch.mean(torch.square(chunks), dim=-1))
    a_state, res = analyzer.analyze(state[:analyzer.STATE_LEN], rms, chunks,
                                    sample_rate)
    ctx = interpreter.interpret(res, sample_rate)
    env, params = mapping.visual_params(state[analyzer.STATE_LEN:], ctx,
                                        res.rms, res.rolling_avg)
    frames = torch.cat([params.light_color, torch.stack([
        params.light_intensity, params.displacement, ctx.energy,
        ctx.brightness, ctx.melancholy, ctx.dominant_pitch,
        ctx.pitch_confidence], dim=-1)], dim=-1)
    return torch.cat([a_state, env[n:], frames.reshape(-1)])


def unpack(out, n):
    """(AnalyzerState, VisualState, VisualParams, MusicalContext) reading
    ``out``, a call's output (``body``'s layout) on the host; the
    parameters and the context with a leading frame axis."""
    frames = out[STATE_LEN:].view(n, FRAME_LEN)
    return (analyzer.AnalyzerState.unpack(out[:analyzer.STATE_LEN]),
            mapping.VisualState(brightness_envelope=out[analyzer.STATE_LEN]),
            mapping.VisualParams(light_color=frames[:, 0:3],
                                 light_intensity=frames[:, 3],
                                 displacement=frames[:, 4]),
            interpreter.MusicalContext(
                energy=frames[:, 5], brightness=frames[:, 6],
                melancholy=frames[:, 7], dominant_pitch=frames[:, 8],
                pitch_confidence=frames[:, 9]))


class TrackGraph:
    """One chunk shape's track captured as a CUDA graph: its static input,
    the graph and the output that every replay rewrites."""

    def __init__(self, n, sample_rate, device):
        self.n, self.sample_rate, self.device = n, sample_rate, device
        # The constants the graph reads, kept alive with it.
        self.constants = analyzer.constants(device, sample_rate)
        self.input = torch.empty(n * FFT_SIZE + STATE_LEN,
                                 dtype=torch.float32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.output = None

    def fill(self, up):
        """Send ``up`` (``upload``) up in one asynchronous copy from
        pinned memory (PyTorch's pinned memory cache keeps the block until
        the copy has run)."""
        self.input.copy_(up.pin_memory(), non_blocking=True)

    def capture(self):
        self.output = capture_graph(
            self.graph, lambda: body(self.input, self.n, self.sample_rate),
            self.device)


# The process's track graphs, keyed by (device, chunks, sample rate).
TRACK_GRAPH = GraphCache()


def _graphed(up, n, sample_rate, device):
    """The call's output through its track graph (the graph's own output,
    which the next replay rewrites), captured first at the shape's second
    call; None where the call runs op by op (off the card, or as
    ``GraphCache.due`` says)."""
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), n, float(sample_rate))
    graph = TRACK_GRAPH.get(key)
    if graph is None and not TRACK_GRAPH.due(key):
        return None
    if graph is None:
        with annotate("mr/track/capture"):
            def make():
                g = TrackGraph(n, sample_rate, device)
                g.fill(up)
                g.capture()
                return g
            graph = TRACK_GRAPH.add(key, make)
    else:
        with annotate("mr/track/replay"):
            graph.fill(up)
            graph.graph.replay()
        TRACK_GRAPH.replays += 1
    return graph.output


def run(samples, sample_rate, a_state, v_state, device):
    """The track of the mono ``samples`` f32[num_frames * 1024] (a trailing
    remainder is dropped) from the host states ``a_state``, ``v_state`` on
    the resolved ``device``: (AnalyzerState, VisualState, VisualParams,
    MusicalContext) on the host, the caller's own, the parameters and the
    context with a leading frame axis. On the card through the track graph
    where the graph cache says so, else op by op."""
    samples = torch.as_tensor(samples, dtype=torch.float32)
    n = samples.shape[0] // FFT_SIZE
    up = upload(samples[:n * FFT_SIZE], a_state, v_state)
    out = _graphed(up, n, sample_rate, device)
    if out is None:
        out = body(up.to(device), n, sample_rate)
    with annotate("mr/track/sync"):
        # The one copy out (on the CPU a copy too): the next replay
        # rewrites a graph's output.
        host = out.to("cpu", copy=True)
    return unpack(host, n)
