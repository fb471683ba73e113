"""``prep_graph_replay_pct``: the share of the program's ``mr/prep`` spans
in the traced window that hold an ``mr/prep/replay`` span, on synthetic
traces built as the harness's own are."""
import pytest

from conftest import BENCH, REPO

LAUNCH = "cudaLaunchKernel"


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
        "prep_graph_replay_pct").read(t)


def preps(inner):
    """A prep a frame at 100 and 500 us, each holding the named spans."""
    out = []
    for t0, names in zip((100.0, 500.0), inner):
        out.append(span("mr/prep", t0, 100.0))
        out += [span(n, t0 + 10.0 + 20.0 * k, 10.0)
                for k, n in enumerate(names)]
    return out


def test_gpubench_replay_pct_every_prep_replayed():
    t = view([kernel(0.0)] + preps([["mr/prep/replay"]] * 2))
    assert read(t) == pytest.approx(100.0)


def test_gpubench_replay_pct_a_capture_is_not_a_replay():
    # The first frame captures the graph; an op-by-op prep's stages are no
    # replay either.
    t = view([kernel(0.0)] + preps([
        ["mr/prep/capture", "mr/prep/bake", "mr/prep/main"],
        ["mr/prep/replay"]]))
    assert read(t) == pytest.approx(50.0)
    t = view([kernel(0.0)] + preps([["mr/prep/bake", "mr/prep/main"]] * 2))
    assert read(t) == pytest.approx(0.0)


def test_gpubench_replay_pct_counts_a_prep_cut_by_the_window():
    # A prep that starts before the window and replays before it opens
    # counts whole; one after the window does not count.
    t = view([kernel(0.0), span("mr/prep", -50.0, 100.0),
              span("mr/prep/replay", -40.0, 10.0),
              span("mr/prep", 300.0, 100.0),
              span("mr/prep/bake", 310.0, 10.0),
              span("mr/prep", 1200.0, 100.0)])
    assert read(t) == pytest.approx(50.0)


@pytest.mark.parametrize("events", [
    [kernel(0.0), span("gpubench:metalrenderer_tpu_torch.passes.pipeline."
                       "prepare_frame", 100.0, 300.0)],
    preps([["mr/prep/replay"]] * 2)], ids=["no_spans", "no_card"])
def test_gpubench_replay_pct_reads_nothing_without_spans_or_card(events):
    assert read(view(events)) is None
