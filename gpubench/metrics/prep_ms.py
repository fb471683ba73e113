"""``prep_ms`` (ms/frame, layer: host prep): the host wall time inside
``passes.pipeline.prepare_frame`` (bake, vertex stage, clipping, triangle
setup, binning, uniforms; called once a frame on every path) over the
traced window, per frame rendered. Moves ``frames_per_s``."""

SPANS = ["metalrenderer_tpu_torch.passes.pipeline.prepare_frame"]


def read(t):
    spans = t.spans(SPANS[0])
    if not spans or not t.frames:
        return None
    return sum(b - a for a, b in spans) * 1e-3 / t.frames
