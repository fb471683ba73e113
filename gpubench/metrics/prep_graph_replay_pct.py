"""``prep_graph_replay_pct`` (%, layer: host prep): the share of the
program's ``mr/prep`` spans (``passes.pipeline.prepare_frame``) in the
traced window that replayed the prep's CUDA graph, that is, hold an
``mr/prep/replay`` span, rather than capturing it or running the prep op
by op. Moves ``frames_per_s``."""
import bisect


def read(t):
    def named(name):
        return sorted((a, b) for n, a, b, c in t.host
                      if c == "user_annotation" and n == name)
    preps = [(a, b) for a, b in named("mr/prep") if b > t.t0 and a < t.t1]
    if not t.device or not preps:
        return None
    starts = [a for a, _ in named("mr/prep/replay")]
    replayed = 0
    for a, b in preps:
        k = bisect.bisect_left(starts, a)
        replayed += k < len(starts) and starts[k] <= b
    return 100.0 * replayed / len(preps)
