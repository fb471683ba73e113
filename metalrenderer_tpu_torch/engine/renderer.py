"""Frame-loop engine: the counterpart of MtlEngine::run, and torch
counterpart of ``metalrenderer_tpu.engine.renderer`` (its audio-reactive
sequences).

The reference's per-frame loop (mtl_engine.mm:68-87) interleaves host-side
uniform rebuilds with two blocking GPU submissions. Here a whole
audio-reactive sequence — analysis, musical interpretation, audio->visual
mapping, scene update, shadow pass, main pass, MSAA resolve — is WAV-like
samples in, frames out, on one device: the track is computed for all
frames at once (``audio_visual_track``; on the card one CUDA graph per
chunk shape, ``audio.track``), brought to the host in one copy with its
states (the frames' scenes and uniforms are built there), and the frames go
through the fused frame batch (kernels K4 + K6) or, for configurations
the fused batch does not take, through ``render_frame`` one by one. A
camera flythrough (``render_camera_path``) slerps PoseCameras between key
poses on the host and renders them the same way.

Frame cadence matches the reference's data flow: one 1024-sample audio
chunk produces one frame's worth of scene parameters (the audio tap fires
every ~21 ms at 48 kHz).
"""
from __future__ import annotations

import torch

from ..audio import analyzer, mapping, track
from ..config import RenderConfig, ShadowConfig
from ..passes.pipeline import (fused_batch_eligible, px_batch_eligible,
                               render_frame, render_frame_batch_fused,
                               render_frame_batch_px, resolve_device)
from ..scene.camera import PoseCamera
from ..scene.lights import Lighting, PointLight
from ..utils.profiling import annotate
from . import audio_app


def audio_visual_track(samples, sample_rate,
                       analyzer_state: analyzer.AnalyzerState = None,
                       visual_state: mapping.VisualState = None,
                       device="cuda"):
    """Audio samples -> per-frame VisualParams (batched over frames),
    computed on ``device``.

    Runs the full audio pipeline (AudioAnalyzer -> MusicalInterpreter ->
    updateSharedTransformData mapping; ``audio.track.run``). Returns
    (analyzer_state, visual_state, VisualParams[batch],
    MusicalContext[batch]), all on the host (the track's one read); the
    states carry a stream from one call to the next."""
    with annotate("mr/track"):
        return track.run(
            samples, sample_rate,
            analyzer.AnalyzerState.init() if analyzer_state is None
            else analyzer_state,
            mapping.VisualState.init() if visual_state is None
            else visual_state, resolve_device(device))


def camera_path(key_poses, frames_per_segment=8):
    """The flythrough's per-frame cameras: F = (len(key_poses) - 1) *
    frames_per_segment + 1 PoseCameras slerped on the host between the key
    poses (PoseCamera, or OrbitCamera converted by ``.pose()``). Frame i
    lies in segment ``min(i // fps, n_seg - 1)`` at ``t = (i - seg * fps) /
    fps`` in f32, as in the JAX package. Raises ValueError with fewer than
    two key poses."""
    poses = [p if isinstance(p, PoseCamera) else p.pose() for p in key_poses]
    if len(poses) < 2:
        raise ValueError("need at least two key poses")
    n_seg, fps = len(poses) - 1, frames_per_segment
    idx = torch.arange(n_seg * fps + 1)
    seg = torch.clamp_max(torch.div(idx, fps, rounding_mode="floor"),
                          n_seg - 1)
    t = (idx - seg * fps).to(torch.float32) / fps
    return [poses[s].slerp(poses[s + 1], tt)
            for s, tt in zip(seg.tolist(), t)]


def render_camera_path(scene, lighting, key_poses, frames_per_segment=8,
                       config: RenderConfig = RenderConfig(),
                       shadow_config: ShadowConfig = ShadowConfig(),
                       displacement=0.0, shadow_target=(0.0, 0.0, 0.0),
                       backend="kernels", device="cuda"):
    """Camera flythrough on ``device``: quaternion slerp between key poses
    (``camera_path``), rendered as one frame batch where the scene takes
    one (the fused batch: K4 + K6; the px batch: K4 + K5 + K8 + K9), else
    frame by frame through ``render_frame``. Returns rgba f32[F, H, W, 4]
    with F = (len(key_poses) - 1) * frames_per_segment + 1.

    Orientation interpolates on the quaternion sphere
    (AAPLMathUtilities.h:242 semantics), so the camera never gimbal-flips
    between keys."""
    cams = camera_path(key_poses, frames_per_segment)
    fused = fused_batch_eligible(scene, lighting, config)
    if backend == "kernels" and (
            fused or px_batch_eligible(scene, lighting, config)):
        batch_fn = render_frame_batch_fused if fused else \
            render_frame_batch_px
        nf = len(cams)
        rgba, _ = batch_fn(scene, cams[0], lighting, config, shadow_config,
                           [displacement] * nf, [0.0] * nf,
                           shadow_target=shadow_target, cameras=cams,
                           backend=backend, device=device)
        return rgba
    return torch.stack([
        render_frame(scene, cam, lighting, config, shadow_config,
                     displacement, shadow_target, backend, device)[0]
        for cam in cams])


def _telemetry(params, ctxs, n):
    return {
        "light_color": params.light_color[:n],
        "light_intensity": params.light_intensity[:n],
        "displacement": params.displacement[:n],
        "energy": ctxs.energy[:n],
        "brightness": ctxs.brightness[:n],
        "melancholy": ctxs.melancholy[:n],
        "pitch_hz": ctxs.dominant_pitch[:n],
        "pitch_confidence": ctxs.pitch_confidence[:n],
    }


class _SequenceRenderer:
    """The AudioApp scene driven by a track's ``VisualParams``: the light
    cube's color and the light's color and intensity follow the audio, the
    main cube's vertices pulse with the displacement."""

    def __init__(self, camera, cube_position, light_position, config,
                 shadow_config, backend, device):
        self.camera = camera or audio_app.default_camera(config.width,
                                                         config.height)
        self.cube_position = tuple(cube_position)
        self.light_position = tuple(light_position)
        self.config, self.shadow_config = config, shadow_config
        self.backend, self.device = backend, resolve_device(device)

    def scene_of(self, p: mapping.VisualParams):
        with annotate("mr/scene"):
            return audio_app.build_scene(self.cube_position,
                                         self.light_position, p.light_color,
                                         device=self.device)

    def lighting_of(self, p: mapping.VisualParams):
        return Lighting(
            light=PointLight(position=self.light_position,
                             color=p.light_color,
                             intensity=p.light_intensity),
            ambient_intensity=0.1, shininess=32.0)

    def takes_fused_batch(self, p: mapping.VisualParams):
        return self.backend == "kernels" and fused_batch_eligible(
            self.scene_of(p), self.lighting_of(p), self.config, self.camera)

    def render(self, params: mapping.VisualParams, n, fused):
        """Frames 0..n-1 of ``params`` -> rgba f32[n, H, W, 4]."""
        with annotate("mr/params/sync"):
            host = params.to("cpu")      # no copy: the track's are on the host
        frames = [host.frame(i) for i in range(n)]
        if fused:
            # The serving shape: the whole sequence in two kernel launches
            # (batched shadow pass + batched fused raster/shade) with
            # per-frame audio-driven scene and lighting.
            rgba, _ = render_frame_batch_fused(
                self.scene_of(frames[0]), self.camera,
                self.lighting_of(frames[0]), self.config, self.shadow_config,
                host.displacement[:n], [self.camera.theta] * n,
                shadow_target=self.cube_position, scene_fn=self.scene_of,
                lighting_fn=self.lighting_of, frame_params=frames,
                backend=self.backend, device=self.device)
            return rgba
        return torch.stack([
            render_frame(self.scene_of(p), self.camera, self.lighting_of(p),
                         self.config, self.shadow_config,
                         float(p.displacement), self.cube_position,
                         self.backend, self.device)[0]
            for p in frames])


def stream_audio_reactive(samples, sample_rate, chunk_frames=16,
                          camera=None,
                          cube_position=(0.0, 0.0, -1.0),
                          light_position=(0.0, 2.0, 0.0),
                          config: RenderConfig = RenderConfig(),
                          shadow_config: ShadowConfig = ShadowConfig(),
                          backend="kernels", device="cuda",
                          analyzer_state: analyzer.AnalyzerState = None,
                          visual_state: mapping.VisualState = None):
    """Streaming serving mode: yield rendered frames as audio arrives.

    The analog of the reference's live path — the CoreAudio tap delivers a
    1024-sample buffer every ~21 ms @48 kHz (AudioInputLayer.mm:22) and
    each buffer drives one frame. Here ``chunk_frames`` buffers are batched
    per render (bounded latency = chunk_frames x 21 ms of audio + one
    batch).

    Analyzer and visual state carry across chunks, so the concatenated
    stream output equals the offline ``render_audio_reactive_sequence``
    (bit for bit on the CPU; on the card the batched FFT may round a
    [chunk_frames, 1024] batch and the whole signal differently).

    Yields (frames f32[<=chunk_frames, H, W, 4], telemetry dict) per chunk.
    The last chunk's audio is zero-padded to ``chunk_frames`` buffers, so
    every chunk's track has one shape, and trimmed before its frames are
    rendered. ``analyzer_state``, ``visual_state``: the carries to start
    from (default: a fresh stream), e.g. restored from a checkpoint
    (``utils.checkpoint``) to resume a stream mid-way."""
    r = _SequenceRenderer(camera, cube_position, light_position, config,
                          shadow_config, backend, device)
    samples = torch.as_tensor(samples, dtype=torch.float32)
    chunk_samples = chunk_frames * analyzer.FFT_SIZE
    n_frames = samples.shape[0] // analyzer.FFT_SIZE
    a_state = (analyzer.AnalyzerState.init() if analyzer_state is None
               else analyzer_state)
    v_state = (mapping.VisualState.init() if visual_state is None
               else visual_state)
    fused = None
    for start in range(0, n_frames, chunk_frames):
        nf = min(chunk_frames, n_frames - start)
        block = samples[start * analyzer.FFT_SIZE:
                        (start + nf) * analyzer.FFT_SIZE]
        if nf < chunk_frames:
            block = torch.nn.functional.pad(
                block, (0, chunk_samples - block.shape[0]))
        a_state, v_state, params, ctxs = audio_visual_track(
            block, sample_rate, a_state, v_state, r.device)
        if fused is None:
            fused = r.takes_fused_batch(params.to("cpu").frame(0))
        yield r.render(params, nf, fused), _telemetry(params, ctxs, nf)


def render_audio_reactive_sequence(
        samples, sample_rate,
        camera=None,
        cube_position=(0.0, 0.0, -1.0),
        light_position=(0.0, 2.0, 0.0),
        config: RenderConfig = RenderConfig(),
        shadow_config: ShadowConfig = ShadowConfig(),
        backend="kernels", max_frames=None, device="cuda"):
    """WAV/array in, frame stack out: f32[F, H, W, 4] plus telemetry, on
    ``device``.

    Equivalent to running the reference app against recorded audio: the
    light cube's color/brightness follow pitch/spectrum and the main
    cube's vertices pulse with loudness (mtl_engine.mm:715-762). An
    untextured point-light configuration with per-pixel shading on 8x128
    tiles takes the fused frame batch (K4 + K6 for the whole sequence);
    any other (supersampled shading, ``fused_shade=False``, other tiles)
    renders frame by frame through ``render_frame``."""
    r = _SequenceRenderer(camera, cube_position, light_position, config,
                          shadow_config, backend, device)
    samples = torch.as_tensor(samples, dtype=torch.float32)
    n = samples.shape[0] // analyzer.FFT_SIZE
    if n == 0:
        raise ValueError("need at least one 1024-sample chunk of audio")
    _, _, params, ctxs = audio_visual_track(samples, sample_rate,
                                            device=r.device)
    if max_frames is not None:
        n = min(n, max_frames)
    fused = r.takes_fused_batch(params.to("cpu").frame(0))
    return r.render(params, n, fused), _telemetry(params, ctxs, n)
