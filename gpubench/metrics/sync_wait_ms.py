"""``sync_wait_ms`` (ms/frame, layer: audio track): the host wall time
inside every program span whose name ends in ``/sync``: the blocking reads
from the card (``mr/track/sync``: the analyzer's and the mapping's copies
to the host; ``mr/params/sync``: the track's parameters brought over
before the frames' scenes are built), per frame rendered. Moves
``frames_per_s``."""
from gpubench.harness import program_spans


def read(t):
    return program_spans.ms_per_frame(t, lambda n: n.endswith("/sync"))
