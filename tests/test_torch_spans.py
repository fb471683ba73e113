"""The frame path's named spans (``utils.profiling.annotate``): a traced
``stream_audio_reactive`` on the CPU holds every ``mr/...`` span where the
benchmark's per-stage metrics read it, and the profiler changes no frame
and no telemetry value."""
import json

import numpy as np
import pytest
import torch

from metalrenderer_tpu_torch.config import RenderConfig
from metalrenderer_tpu_torch.engine import renderer
from metalrenderer_tpu_torch.scene.camera import OrbitCamera
from metalrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)
SR = 48000.0
N_FRAMES = 4
CFG = RenderConfig(width=64, height=48, msaa=4, shadow_map_size=64)
CAM = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=64 / 48)
PREP_STAGES = ("mr/prep/bake", "mr/prep/shadow", "mr/prep/shadow_bin",
               "mr/prep/main", "mr/prep/main_bin")
SPAN_NAMES = {"mr/track", "mr/track/sync", "mr/params/sync", "mr/scene",
              "mr/prep", *PREP_STAGES, "mr/stack", "mr/raster"}


def _signal():
    """Four buffers at microphone level: a 220 Hz tone rising into
    seeded noise, so that consecutive frames differ."""
    t = np.arange(N_FRAMES * 1024) / SR
    rng = np.random.default_rng(7)
    sig = 0.004 * np.sin(2 * np.pi * 220.0 * t) * np.linspace(0.5, 2.0,
                                                              t.size)
    return (sig + 0.002 * rng.standard_normal(t.size)).astype(np.float32)


def _stream(chunk_frames):
    return list(renderer.stream_audio_reactive(
        _signal(), SR, chunk_frames, camera=CAM, config=CFG, device="cpu"))


@pytest.fixture(scope="module", params=[1, 2], ids=lambda c: f"chunk{c}")
def runs(request, tmp_path_factory):
    """(chunk_frames, chunks untraced, chunks traced, the traced run's
    mr/ spans as (name, start, end))."""
    plain = _stream(request.param)
    with profiling.device_trace(tmp_path_factory.mktemp("trace")) as prof:
        traced = _stream(request.param)
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("mr/")]
    return request.param, plain, traced, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_stream_holds_every_span_of_the_frame_path(runs):
    chunk_frames, _, _, spans = runs
    n_chunks = N_FRAMES // chunk_frames
    assert {n for n, _, _ in spans} == SPAN_NAMES
    named = {n: [s for s in spans if s[0] == n] for n in SPAN_NAMES}
    # One prep a frame, its five stages inside it, each once, none inside
    # another.
    assert len(named["mr/prep"]) == N_FRAMES
    for prep in named["mr/prep"]:
        stages = sorted((s for s in spans if s[0] in PREP_STAGES
                         and _inside(s, prep)), key=lambda s: s[1])
        assert sorted(s[0] for s in stages) == sorted(PREP_STAGES)
        assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    for stage in PREP_STAGES:
        assert len(named[stage]) == N_FRAMES
    # One track a chunk, its one host read inside it; one read of the
    # track's parameters and two raster launches (K4, K6) a chunk; a stack
    # a frame (its copy into the batch's slot, after its prep); a scene a
    # frame and one more a chunk (the batch's template).
    assert len(named["mr/track"]) == n_chunks
    assert len(named["mr/track/sync"]) == n_chunks
    for sync in named["mr/track/sync"]:
        assert any(_inside(sync, t) for t in named["mr/track"])
    assert len(named["mr/params/sync"]) == n_chunks
    assert len(named["mr/stack"]) == N_FRAMES
    assert len(named["mr/raster"]) == 2 * n_chunks
    # The first chunk also builds a scene to choose the branch.
    assert len(named["mr/scene"]) == N_FRAMES + n_chunks + 1
    for s in named["mr/scene"] + named["mr/params/sync"] + named["mr/stack"]:
        assert not any(_inside(s, p) for p in named["mr/prep"])


def test_stream_is_bit_equal_traced_and_untraced(runs):
    _, plain, traced, _ = runs
    assert len(plain) == len(traced)
    for (fa, ta), (fb, tb) in zip(plain, traced):
        assert torch.equal(fa, fb)
        assert set(ta) == set(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k


def _entry(name):
    """One call of the entry ``name`` on a 2-frame AudioApp scene."""
    from metalrenderer_tpu_torch import render_batch
    from metalrenderer_tpu_torch.engine import audio_app
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.scene.lights import Lighting
    scene = audio_app.build_scene(device="cpu")
    if name == "mr/frame":
        return pipeline.render_frame(scene, CAM, Lighting.default(), CFG,
                                     displacement=0.02, device="cpu")[0]
    return render_batch(scene, CAM, Lighting.default(), [0.0, 0.02],
                        config=CFG, device="cpu")[0]


@pytest.mark.parametrize("name,frames", [("mr/frame", 1), ("mr/batch", 2)])
def test_entry_span_holds_the_call(name, frames, tmp_path):
    """``render_frame`` opens one ``mr/frame`` span and ``render_batch`` one
    ``mr/batch`` span around their bodies: every other span of the call
    (each frame's prep, the raster launches) lies inside it, and the
    frames are bit-equal traced and untraced."""
    plain = _entry(name)
    with profiling.device_trace(tmp_path) as prof:
        traced = _entry(name)
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("mr/")]
    outer = [s for s in spans if s[0] == name]
    assert len(outer) == 1
    assert not any(s[0] in ("mr/frame", "mr/batch") and s[0] != name
                   for s in spans)
    inner = [s for s in spans if s[0] != name]
    assert sum(s[0] == "mr/prep" for s in inner) == frames
    assert any(s[0] == "mr/raster" for s in inner)
    assert all(_inside(s, outer[0]) for s in inner)
    assert torch.equal(plain, traced)
