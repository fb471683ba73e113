"""BASELINE config 4 in the benchmark: the orbit traffic sends the same
work from every seed and the same angles to the window and the warm-up,
the benchmark's normal map and mip chains are the port's, and the port's
split path renders the orbit's frames within the cell's limits of the
repaired reference, on the CPU at 160x120."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import BENCH

CELL = "config4-frame"


def files():
    config = json.loads((BENCH / "configs" / "config4-1080p.json")
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / "orbit-frame.json")
                         .read_text())
    limits = json.loads((BENCH / "workloads" / f"{CELL}.json")
                        .read_text())["limits"]
    return config, traffic, limits


def test_gpubench_orbit_seed_moves_only_the_phase():
    from gpubench.harness import inputs
    config, traffic, _ = files()
    period = traffic["period_frames"]
    theta0 = config["camera"]["theta"]
    a = np.array(inputs.orbit_thetas(traffic, theta0, 0, 2 * period, 3))
    b = np.array(inputs.orbit_thetas(traffic, theta0, 0, 2 * period,
                                     2 ** 40 + 11))
    # Every seed: one turn every period_frames, in even steps.
    for t in (a, b):
        step = np.diff(t[:period])
        assert step == pytest.approx(np.full(period - 1, 2 * np.pi / period),
                                     abs=1e-5)
        assert np.array_equal(t[:period], t[period:])
    # The seeds differ by one constant: the phase.
    d = b - a
    assert np.ptp(d) < 1e-5 and abs(d[0]) > 1e-3
    # Nothing but the angle: no frame is displaced.
    for f in inputs.frames(traffic, config, 0, 5, 7):
        assert set(f) == {"displacement", "theta"}
        assert f["displacement"] == 0.0


@pytest.mark.parametrize("k", [1, 4, 239])
def test_gpubench_orbit_warmup_and_window_share_angles(k):
    """Warm-up frame -k and window frame period - k: the same angle, bit
    for bit, as ``inputs.frames`` sends them."""
    from gpubench.harness import inputs
    config, traffic, _ = files()
    period = traffic["period_frames"]
    seed = 2 ** 33 + 5
    warm = inputs.frames(traffic, config, -k, 1, seed)[0]
    window = inputs.frames(traffic, config, period - k, 1, seed)[0]
    assert warm == window
    assert isinstance(window["theta"], float)
    assert np.float32(window["theta"]) == window["theta"]


def test_gpubench_normal_map_and_mips_equal_the_ports():
    from gpubench.harness import inputs
    from gpubench.reference import textures
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.io import textures as port_textures
    config, _, _ = files()
    base = inputs.mesh_arrays(config)["textures"][0]
    theirs = configs.bumpy_normal_map(256)
    assert len(theirs) == 9
    ours = textures.from_array(base)
    program = port_textures.from_array(base, generate_mips=True)
    for a, b, c in zip(ours, theirs, program, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


def small_config():
    config, _, _ = files()
    config["render"].update(width=160, height=120, shadow_map_size=256)
    return config


@pytest.mark.parametrize("frame", [0, 61, 170])
def test_gpubench_config4_program_within_the_cells_limits(frame):
    """The port's ``render_frame`` on the CPU (the kernels' plain twins),
    built by the harness from the configuration file, against the
    reference at three orbit frames."""
    from gpubench.harness import check, entries, inputs
    from metalrenderer_tpu_torch.passes import pipeline, prep
    config = small_config()
    _, traffic, limits = files()
    arrays = inputs.mesh_arrays(config)
    fi = inputs.frames(traffic, config, frame, 1, 2 ** 35 + 9)[0]
    scene, camera, lighting, render, shadow, target = entries.port_scene(
        config, arrays, "cpu")
    assert len(scene.textures) == 1
    assert scene.instances[0].material.normal_map_id == 0
    # The split path: the frame cannot take the fused kernel.
    assert not prep.fused_ok(scene, lighting, render)
    camera = dataclasses.replace(camera, theta=fi["theta"])
    prog, _ = pipeline.render_frame(scene, camera, lighting, render, shadow,
                                    fi["displacement"], target, device="cpu")
    ref, counts = check.reference_frame(config, arrays, fi,
                                        torch.device("cpu"), count=True)
    frame_mae, tile_mae = check.frame_gaps(prog, ref)
    assert frame_mae <= limits["frame_mae"]
    assert tile_mae <= limits["tile_mae"]
    # The frame exercises what the cell is for: the normal-mapped cube
    # and the sun's shadow on the floor.
    assert counts["normal_mapped"] > 0 and counts["shadow_tested"] > 0
    assert counts["shadow"] > 0
