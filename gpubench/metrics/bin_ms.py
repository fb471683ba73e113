"""``bin_ms`` (ms/frame, layer: host prep): the host wall time inside the
program's ``mr/prep/shadow_bin`` and ``mr/prep/main_bin`` spans (each
pass's ``build_tri_fields``, the main pass's ``build_attr_fields``, and
``bin_triangles``), per frame rendered. Moves ``frames_per_s``."""
from gpubench.harness import program_spans

BIN_SPANS = ("mr/prep/shadow_bin", "mr/prep/main_bin")


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n in BIN_SPANS)
