"""``correct`` comes out false for the control (the reference in bfloat16
in the program's place) and for each fault a cell can have, planted under
the timed path; true for the program as it is. On the CPU at the tests'
size; ``-m cuda`` also runs the control on the card at the cells' size."""
import json
import pathlib
import sys
import time

import pytest
import torch

from conftest import REPO, run_cell

sys.path.insert(0, str(REPO / "gpubench"))
import calibrate  # noqa: E402

CELLS = ["audioapp-live", "sphere1m-4k-frame", "audioapp-stream",
         "sphere1m-4k-batch2", "config4-frame", "config3-obj-frame"]


@pytest.mark.parametrize("cell", CELLS)
def test_gpubench_the_program_is_correct(tiny_bench, cell):
    bench, root = tiny_bench
    result, _ = run_cell(bench, root, cell)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("seed", [3, 1 << 40, 2 ** 31 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_gpubench_the_control_is_not_correct(tiny_bench, cell, seed):
    bench, root = tiny_bench
    result, _ = run_cell(bench, root, cell, seed=seed, seconds=0.05,
                         make_driver=lambda *a: calibrate.ControlDriver(*a))
    assert result["correct"] is False


class Fault:
    """The program's driver with one fault planted where its output is
    produced."""

    def __init__(self, kind, *args):
        from gpubench.harness import entries
        self.kind, self.inner = kind, entries.make(*args)
        self.last = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def request(self, i):
        frames, track = self.inner.request(i)
        if self.kind == "state_unchanged":
            # Every request after the first returns the first one's output.
            if self.last is None:
                self.last = (frames.clone(), track)
            frames, track = self.last
        elif self.kind == "half_batch":
            # The second half of the request's frames left out, the first
            # half's put in their place.
            h = frames.shape[0] // 2
            frames = torch.cat([frames[:frames.shape[0] - h], frames[:h]])
        elif self.kind == "frame_altered":
            frames = frames.clone()
            frames[-1, :8, :8, :3] += 0.25
        elif self.kind == "track_altered":
            track = (track[0], track[1] * 1.01, track[2])
        return frames, track


FAULTS = [("audioapp-live", "state_unchanged"),
          ("audioapp-live", "frame_altered"),
          ("audioapp-live", "track_altered"),
          ("audioapp-stream", "state_unchanged"),
          ("audioapp-stream", "half_batch"),
          ("audioapp-stream", "frame_altered"),
          ("audioapp-stream", "track_altered"),
          ("sphere1m-4k-frame", "state_unchanged"),
          ("sphere1m-4k-frame", "frame_altered"),
          ("sphere1m-4k-batch2", "state_unchanged"),
          ("sphere1m-4k-batch2", "half_batch"),
          ("sphere1m-4k-batch2", "frame_altered"),
          ("config4-frame", "state_unchanged"),
          ("config4-frame", "frame_altered"),
          ("config3-obj-frame", "state_unchanged"),
          ("config3-obj-frame", "frame_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_gpubench_a_planted_fault_is_not_correct(tiny_bench, cell, fault):
    bench, root = tiny_bench
    result, _ = run_cell(bench, root, cell, seconds=0.1, min_requests=3,
                         make_driver=lambda *a: Fault(fault, *a))
    assert result["correct"] is False, result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_gpubench_the_control_on_the_card(cell):
    """The control at the cell's own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gpubench.harness import core
    bench = REPO / "BENCHMARK.json"
    result, _ = core.run(bench, pathlib.Path(REPO / "gpubench"), cell, 11,
                         1.0, False, torch.device("cuda"), time.perf_counter(),
                         make_driver=lambda *a: calibrate.ControlDriver(*a),
                         log=lambda *a: None)
    assert result["correct"] is False
