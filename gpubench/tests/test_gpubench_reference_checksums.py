"""The reference frames of the cells that were there before config 4 did
not move when the reference learnt the directional light, the normal map
and the orbit: at 160x120 (a 10,000-triangle sphere) their rgba bytes
hash to what the reference gave before, and the work counted for the
rooflines is the same."""
import hashlib
import json

import pytest
import torch

from conftest import BENCH

# sha256 of the float32 rgba bytes and the fragment counts, computed with
# the reference as it was before this one learnt the directional light.
BEFORE = {
    "audioapp-1080p": (
        "1cf866aeb047743dc3ceb2ae4c505e671d1d8155d7679af824da49d5d4c53b92",
        {"main": 79233, "shadow": 1320}),
    "sphere1m-4k": (
        "6481ff710963fdaf1f1e0850c349f0176c5ddf4bc617301883df31c0bba68206",
        {"main": 4680, "shadow": 0}),
}
INPUTS = {
    "audioapp-1080p": {"displacement": 0.4, "light_color": (1.0, 0.6, 0.2),
                       "light_intensity": 0.8},
    "sphere1m-4k": {"displacement": 0.03},
}


def small(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    r = config["render"]
    r.update(width=160, height=120,
             shadow_map_size=min(r["shadow_map_size"], 256))
    for inst in config["instances"]:
        if inst["mesh"]["kind"] == "dense_sphere":
            inst["mesh"]["target_tris"] = 10000
    return config


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_gpubench_reference_frames_of_the_older_cells_are_unchanged(name):
    from gpubench.harness import check, inputs
    config = small(name)
    rgba, counts = check.reference_frame(
        config, inputs.mesh_arrays(config), INPUTS[name],
        torch.device("cpu"), count=True)
    digest, fragments = BEFORE[name]
    assert hashlib.sha256(rgba.contiguous().numpy().tobytes()).hexdigest() \
        == digest
    assert {k: counts[k] for k in fragments} == fragments
