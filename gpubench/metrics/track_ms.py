"""``track_ms`` (ms/frame, layer: audio track): the host wall time inside
``engine.renderer.audio_visual_track`` (analysis, interpretation, mapping;
it ends in the track's copies to the host) over the traced window, per
frame rendered. Moves ``frames_per_s``."""

SPANS = ["metalrenderer_tpu_torch.engine.renderer.audio_visual_track"]


def read(t):
    spans = t.spans(SPANS[0])
    if not spans or not t.frames:
        return None
    return sum(b - a for a, b in spans) * 1e-3 / t.frames
