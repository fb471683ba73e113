"""``main_geom_ms`` (ms/frame, layer: host prep): the host wall time
inside the program's ``mr/prep/main`` spans (``prepare_main_pass``: the
camera projection, near and guard-band clip and triangle setup, and the
stats that follow it), per frame rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n == "mr/prep/main")
