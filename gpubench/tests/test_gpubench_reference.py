"""The benchmark's reference is a frozen copy of the port's oracle path:
at the tests' size on the CPU its meshes, track and frames equal the
port's own (``backend="reference"``, the audio chain)."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, shrink


def config(name):
    return shrink(json.loads((BENCH / "configs" / f"{name}.json")
                             .read_text()))


def test_gpubench_reference_meshes_equal_the_ports():
    from gpubench.reference import scene
    from metalrenderer_tpu_torch.scene import mesh
    for ours, theirs in ((scene.cube(), mesh.cube()),
                         (scene.plane(), mesh.plane())):
        for f in ("positions", "uvs", "normals"):
            assert torch.equal(getattr(ours, f), getattr(theirs, f))


def test_gpubench_dense_sphere_equals_the_ports():
    from gpubench.harness import inputs
    from metalrenderer_tpu_torch.engine import configs
    m = configs._dense_sphere_mesh(5000)
    for a, b in zip(inputs.dense_sphere_arrays(5000),
                    (m.positions, m.uvs, m.normals)):
        assert np.array_equal(a, b.numpy())


def test_gpubench_reference_track_equals_the_ports():
    from gpubench.harness import inputs
    from gpubench.reference import audio
    from metalrenderer_tpu_torch.engine import renderer
    traffic = json.loads((BENCH / "traffic" / "audio-live.json").read_text())
    x = inputs.audio_signal(traffic, 300, 77)
    _, _, params, _ = renderer.audio_visual_track(
        torch.from_numpy(x), 48000.0, device="cpu")
    ours = audio.track(x, 48000.0)
    for a, b in zip(ours, (params.light_color, params.light_intensity,
                           params.displacement)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("name,disp", [("audioapp-1080p", 0.4),
                                       ("sphere1m-4k", 0.03),
                                       ("config4-1080p", 0.0),
                                       ("config3-obj-1080p", 0.0)])
def test_gpubench_reference_frame_equals_the_ports_oracle(name, disp,
                                                          tmp_path):
    from gpubench.harness import check, entries, inputs
    from metalrenderer_tpu_torch.passes import pipeline
    cfg = config(name)
    arrays = inputs.mesh_arrays(cfg, tmp_path)
    fi = {"displacement": disp}
    if name.startswith("audioapp"):
        fi.update(light_color=(1.0, 0.6, 0.2), light_intensity=1.0)
        cfg["light"]["color"] = list(fi["light_color"])
        cfg["instances"][1]["material"]["color"] = list(fi["light_color"])
    ours = check.reference_frame(cfg, check.reference_arrays(arrays), fi,
                                 torch.device("cpu"))
    scene, camera, lighting, render, shadow, target = entries.port_scene(
        cfg, arrays, "cpu")
    theirs, _ = pipeline.render_frame(scene, camera, lighting, render,
                                      shadow, disp, target,
                                      backend="reference", device="cpu")
    assert torch.equal(ours, theirs)
