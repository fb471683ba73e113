"""The reference frames of the older cells did not move when the
reference learnt the directional light, the normal map and the orbit (the
cells before config 4), or the OBJ mesh, the color texture and the
rotation (the cells before config 3): at 160x120 (a 10,000-triangle
sphere) their rgba bytes hash to what the reference gave before, and the
work counted for the rooflines is the same. Config 3's frame is held too,
at the same size, from here on."""
import hashlib
import json

import pytest
import torch

from conftest import BENCH

# sha256 of the float32 rgba bytes and the fragment counts, computed with
# the reference as it was before it learnt the directional light (audioapp,
# sphere) and before it learnt the OBJ mesh and the color texture (config
# 4), and config 3's as the reference first rendered it.
BEFORE = {
    "audioapp-1080p": (
        "1cf866aeb047743dc3ceb2ae4c505e671d1d8155d7679af824da49d5d4c53b92",
        {"main": 79233, "shadow": 1320}),
    "sphere1m-4k": (
        "6481ff710963fdaf1f1e0850c349f0176c5ddf4bc617301883df31c0bba68206",
        {"main": 4680, "shadow": 0}),
    "config4-1080p": (
        "66560584c52650723650cd1d6eb050a3eeba04fa06ab7e7db82f7f5f580724e6",
        {"main": 68498, "shadow": 828, "shaded": 15173,
         "normal_mapped": 2006, "shadow_tested": 13167}),
    "config3-obj-1080p": (
        "dbd291aadbf41a01e02ceedbe7ed9a4a5ffdf5b1637162a8a2122d94393714e8",
        {"main": 4377, "shadow": 0, "shaded": 4377, "normal_mapped": 0,
         "textured": 4377, "shadow_tested": 0}),
}
INPUTS = {
    "audioapp-1080p": {"displacement": 0.4, "light_color": (1.0, 0.6, 0.2),
                       "light_intensity": 0.8},
    "sphere1m-4k": {"displacement": 0.03},
    "config4-1080p": {"displacement": 0.0},
    "config3-obj-1080p": {"displacement": 0.0},
}


def small(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    r = config["render"]
    r.update(width=160, height=120,
             shadow_map_size=min(r["shadow_map_size"], 256))
    for inst in config["instances"]:
        if "target_tris" in inst["mesh"]:
            inst["mesh"]["target_tris"] = 10000
    return config


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_gpubench_reference_frames_of_the_older_cells_are_unchanged(
        name, tmp_path):
    from gpubench.harness import check, inputs
    config = small(name)
    rgba, counts = check.reference_frame(
        config, check.reference_arrays(inputs.mesh_arrays(config, tmp_path)),
        INPUTS[name], torch.device("cpu"), count=True)
    digest, fragments = BEFORE[name]
    assert hashlib.sha256(rgba.contiguous().numpy().tobytes()).hexdigest() \
        == digest
    assert {k: counts[k] for k in fragments} == fragments
