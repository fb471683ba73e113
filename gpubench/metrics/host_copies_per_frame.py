"""``host_copies_per_frame`` (copies, layer: host prep): the
``cudaMemcpy`` and ``cudaMemcpyAsync`` calls that start inside any of the
program's ``mr/`` spans (each counted once however many spans nest
around it), per frame rendered: the copies the frame path makes, to,
from and within the card. Moves ``frames_per_s``."""
from gpubench.harness import program_spans

COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync")


def read(t):
    return program_spans.calls_per_frame(t, COPY_CALLS, lambda n: True)
