"""``bake_ms`` (ms/frame, layer: host prep): the host wall time inside the
program's ``mr/prep/bake`` spans (``scene.bake`` in
``passes.pipeline.prepare_frame``: the vertex stage and the displacement),
per frame rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n == "mr/prep/bake")
