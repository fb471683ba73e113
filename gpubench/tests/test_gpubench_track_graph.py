"""``track_graph_replay_pct``: the share of the program's ``mr/track``
spans in the traced window that hold an ``mr/track/replay`` span, on
synthetic traces built as the harness's own are."""
import pytest

from conftest import BENCH, REPO


def view(events, frames=2):
    from gpubench.harness import trace
    window = {"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0,
              "dur": 1000.0, "cat": "user_annotation"}
    return trace.TraceView([window] + events, frames, frames, {}, {})


def span(name, ts, dur):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur,
            "cat": "user_annotation"}


def kernel(ts):
    return {"name": "kernel_a", "ph": "X", "ts": ts, "dur": 10.0,
            "cat": "kernel"}


def read(t):
    from gpubench.harness import core
    return core.Catalog(REPO / "BENCHMARK.json", BENCH).metric_reader(
        "track_graph_replay_pct").read(t)


def tracks(inner):
    """A track call a frame at 100 and 500 us, each holding the named
    spans."""
    out = []
    for t0, names in zip((100.0, 500.0), inner):
        out.append(span("mr/track", t0, 100.0))
        out += [span(n, t0 + 10.0 + 20.0 * k, 10.0)
                for k, n in enumerate(names)]
    return out


def test_gpubench_track_replay_pct_every_call_replayed():
    t = view([kernel(0.0)] + tracks([["mr/track/replay",
                                      "mr/track/sync"]] * 2))
    assert read(t) == pytest.approx(100.0)


def test_gpubench_track_replay_pct_a_capture_is_not_a_replay():
    # The second call of a shape captures the graph; an op-by-op call's
    # read is no replay either, nor is a prep's replay.
    t = view([kernel(0.0)] + tracks([["mr/track/capture", "mr/track/sync"],
                                     ["mr/track/replay", "mr/track/sync"]]))
    assert read(t) == pytest.approx(50.0)
    t = view([kernel(0.0)] + tracks([["mr/track/capture", "mr/track/sync"],
                                     ["mr/track/sync", "mr/prep/replay"]]))
    assert read(t) == pytest.approx(0.0)


def test_gpubench_track_replay_pct_counts_a_call_cut_by_the_window():
    # A call that starts before the window and replays before it opens
    # counts whole; one after the window does not count.
    t = view([kernel(0.0), span("mr/track", -50.0, 100.0),
              span("mr/track/replay", -40.0, 10.0),
              span("mr/track", 300.0, 100.0),
              span("mr/track/sync", 310.0, 10.0),
              span("mr/track", 1200.0, 100.0),
              span("mr/track/replay", 1210.0, 10.0)])
    assert read(t) == pytest.approx(50.0)


def test_gpubench_track_replay_pct_reads_0_where_the_track_runs_op_by_op():
    # A program whose track never engages its graph (as the parent's has
    # none) reads 0, not nothing.
    t = view([kernel(0.0)] + tracks([["mr/track/sync", "mr/prep/replay"]]
                                    * 2))
    assert read(t) == pytest.approx(0.0)


@pytest.mark.parametrize("events", [
    [kernel(0.0), span("gpubench:metalrenderer_tpu_torch.engine.renderer."
                       "audio_visual_track", 100.0, 300.0)],
    tracks([["mr/track/replay"]] * 2)],
    ids=["no_spans", "no_card"])
def test_gpubench_track_replay_pct_reads_nothing_without_spans_or_card(
        events):
    assert read(view(events)) is None
