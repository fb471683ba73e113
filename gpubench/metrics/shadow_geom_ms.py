"""``shadow_geom_ms`` (ms/frame, layer: host prep): the host wall time
inside the program's ``mr/prep/shadow`` spans (the shadow pass's light
matrices, projection, near clip, triangle setup and cast-shadow mask in
``passes.pipeline.prepare_frame``), per frame rendered. Moves
``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n == "mr/prep/shadow")
