"""``scene_ms`` (ms/frame, layer: host prep): the host wall time inside
the program's ``mr/scene`` spans (``engine.renderer._SequenceRenderer.
scene_of``: ``audio_app.build_scene`` and its copy to the card, each time
it runs), per frame rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n == "mr/scene")
