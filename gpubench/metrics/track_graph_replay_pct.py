"""``track_graph_replay_pct`` (%, layer: audio track): the share of the
program's ``mr/track`` spans (``engine.renderer.audio_visual_track``) in
the traced window that replayed the track's CUDA graph, that is, hold an
``mr/track/replay`` span, rather than capturing it or running the track op
by op. Moves ``frames_per_s``."""
import bisect


def read(t):
    def named(name):
        return sorted((a, b) for n, a, b, c in t.host
                      if c == "user_annotation" and n == name)
    tracks = [(a, b) for a, b in named("mr/track") if b > t.t0 and a < t.t1]
    if not t.device or not tracks:
        return None
    starts = [a for a, _ in named("mr/track/replay")]
    replayed = 0
    for a, b in tracks:
        k = bisect.bisect_left(starts, a)
        replayed += k < len(starts) and starts[k] <= b
    return 100.0 * replayed / len(tracks)
