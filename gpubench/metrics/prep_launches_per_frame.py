"""``prep_launches_per_frame`` (launches, layer: host prep): the CUDA
kernel-launch calls (``launches_per_frame.LAUNCH_CALLS``) that start
inside the program's ``mr/prep`` spans (``passes.pipeline.prepare_frame``),
per frame rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.calls_per_frame(t, program_spans.LAUNCH_CALLS,
                                         lambda n: n == "mr/prep")
