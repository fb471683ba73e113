"""CUDA graphs by shape: the capture of a piece of device work and the
cache that decides, shape by shape, whether a call captures, replays or
runs op by op. The frame prep (``passes.prep.PREP_GRAPH``) and the audio
track (``audio.track.TRACK_GRAPH``) each keep one ``GraphCache``.
"""
from __future__ import annotations

import collections

import torch


def capture_graph(graph, run, device):
    """Run ``run()`` once op by op on a side stream (PyTorch's warm-up
    before a capture: cuFFT's plans and the like are made there), capture
    it into the CUDA graph ``graph`` on ``device``, replay it, and return
    the captured call's outputs, which every replay rewrites."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            out = run()
        graph.replay()
    return out


class GraphCache:
    """CUDA graphs by shape key, the least recently used first, at most
    ``size`` (each graph's memory pool holds every intermediate of its
    work).

    A shape is captured at its second call (``due``); its first runs op
    by op, so a one-off call (a single render, a session's frame after a
    resize) costs what it did before graphs, not a capture (tens of op-by-
    op calls). A shape whose graph was freed runs op by op from then on,
    so shapes taking turns beyond ``size`` never recapture in turn.
    ``seen`` remembers the last ``remembered`` shapes without a graph;
    ``captures`` and ``replays`` count the graphed calls."""

    def __init__(self, size=4, remembered=64):
        self.size, self.remembered = size, remembered
        self.graphs = collections.OrderedDict()
        # key -> calls run op by op, or None once its graph was freed.
        self.seen = collections.OrderedDict()
        self.captures = 0
        self.replays = 0

    def get(self, key):
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def due(self, key):
        """Count a call of ``key``, which has no graph: whether it
        captures one (its second call, if its graph was never freed)."""
        calls = self.seen.pop(key, 0)
        self.seen[key] = None if calls is None else calls + 1
        while len(self.seen) > self.remembered:
            self.seen.popitem(last=False)
        return calls == 1

    def add(self, key, make):
        """Free the least recently used graphs beyond ``size - 1``, then
        ``make()`` this key's graph and keep it."""
        while len(self.graphs) >= self.size:
            freed, _ = self.graphs.popitem(last=False)
            self.seen.pop(freed, None)
            self.seen[freed] = None
        graph = self.graphs[key] = make()
        self.captures += 1
        return graph

    def clear(self):
        """Free every graph and forget every shape."""
        self.graphs.clear()
        self.seen.clear()
