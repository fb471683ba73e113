"""``track_launches_per_frame`` (launches, layer: audio track): the CUDA
kernel-launch calls (``launches_per_frame.LAUNCH_CALLS``) that start
inside the program's ``mr/track`` spans (``engine.renderer.
audio_visual_track``: analysis, interpretation, mapping), per frame
rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.calls_per_frame(t, program_spans.LAUNCH_CALLS,
                                         lambda n: n == "mr/track")
