"""What ``correct`` compares sees a small wrong area at the cells' own frame
size, and the audio traffic drives the light through its range."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def cell_files(cell):
    row = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = json.loads((BENCH / "configs" / f"{row['config']}.json")
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{row['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    return config, traffic, limits


def wrong_area(frame, kind):
    """``frame`` with one small wrong area planted away from tile corners."""
    frame = frame.clone()
    if kind == "block":     # 8 x 8 pixels, 0.25 too bright, over four tiles
        frame[101:109, 203:211, :3] += 0.25
    else:                   # one pixel several hundred times too bright
        frame[378, 1879, :3] *= 448.0
    return frame


@pytest.mark.parametrize("kind", ["block", "pixel"])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_gpubench_a_small_wrong_area_fails_at_the_cells_size(cell, kind):
    from gpubench.harness import check
    config, _, limits = cell_files(cell)
    h, w = config["render"]["height"], config["render"]["width"]
    ref = torch.full((h, w, 4), 0.5)
    frame_mae, tile_mae = check.frame_gaps(wrong_area(ref, kind), ref)
    assert frame_mae <= limits["frame_mae"]
    assert tile_mae > limits["tile_mae"]


def test_gpubench_a_gap_that_is_not_finite_fails():
    from gpubench.harness import check
    ref = torch.zeros(16, 24, 4)
    frame = ref.clone()
    frame[3, 5, 1] = float("nan")
    assert check.frame_gaps(frame, ref) == (np.inf, np.inf)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]
                                  if w["traffic"].startswith("audio")])
def test_gpubench_the_traffic_moves_the_light(cell):
    """Over a window's worth of buffers the light's intensity leaves the
    clamp, rises and decays, and the gate greys the light and lets the
    color through."""
    from gpubench.harness import check, inputs
    from gpubench.reference import audio
    _, traffic, limits = cell_files(cell)
    x = inputs.audio_signal(traffic, 1200, 2 ** 40 + 3)
    color, intensity, _ = audio.track(x, float(traffic["sample_rate"]))
    clamped = float(np.mean(intensity >= check.INTENSITY_CLAMP))
    assert clamped <= limits["intensity_clamped_share"]
    assert intensity.min() < 0.5 and intensity.max() >= 1.0
    step = np.diff(intensity)
    assert (step > 0.01).any() and (step < -0.01).any()
    grey = np.all(np.isclose(color, intensity[:, None] / 3.0), axis=1)
    assert 0.2 < grey.mean() < 0.8
