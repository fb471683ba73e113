"""BASELINE config 3 in the benchmark: the harness writes the OBJ file the
port's ``io/obj.save_obj`` would, the port's loader (both parsers) and
the reference's own reader read it back bit for bit, the checkerboard is
the port's, the port's split path renders a small config-3 frame within
the cell's limits of the reference, and the same frame without the
texture does not. Also the mesh kind and the rotation that let config 2
come as data alone."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import BENCH

CELL = "config3-obj-frame"


def files():
    config = json.loads((BENCH / "configs" / "config3-obj-1080p.json")
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / "orbit-frame.json")
                         .read_text())
    limits = json.loads((BENCH / "workloads" / f"{CELL}.json")
                        .read_text())["limits"]
    return config, traffic, limits


def test_gpubench_obj_writer_and_readers_agree_bit_for_bit(tmp_path):
    from gpubench.harness import inputs
    from gpubench.reference import obj as ref_obj
    from metalrenderer_tpu_torch.io import native, obj
    from metalrenderer_tpu_torch.scene import mesh
    arrays = inputs.dense_sphere_arrays(3000)
    ours, theirs = tmp_path / "harness.obj", tmp_path / "port.obj"
    inputs.write_obj(ours, *arrays)
    obj.save_obj(theirs, mesh.from_numpy(*arrays))
    assert ours.read_bytes() == theirs.read_bytes()
    readings = {"reference": ref_obj.load(ours)}
    parsers = [False] + ([True] if native.native_available() else [])
    for use_native in parsers:
        m = obj.load_obj(ours, use_native=use_native)
        readings[f"native={use_native}"] = [
            t.numpy() for t in (m.positions, m.uvs, m.normals)]
    for what, read in readings.items():
        inputs.same_bits(read, arrays, what)


def test_gpubench_same_bits_tells_a_flipped_bit_and_a_signed_zero():
    from gpubench.harness import inputs
    arrays = inputs.dense_sphere_arrays(500)
    inputs.same_bits(arrays, arrays, "itself")
    flipped = [a.copy() for a in arrays]
    flipped[2].view(np.uint32)[7, 1] ^= 1
    zero = [a.copy() for a in arrays]
    zero[1][zero[1] == 0.0] = -0.0
    for read in (flipped, zero, arrays[:2] + (arrays[2][:-3],)):
        with pytest.raises(RuntimeError):
            inputs.same_bits(read, arrays, "a bad reading")


def test_gpubench_reference_obj_reader_rejects_other_faces(tmp_path):
    """A triangle of 1-based ``v/vt/vn`` corners reads back; a quad, a
    corner without its uv, an index out of range and a negative index,
    none of which the harness writes, raise."""
    from gpubench.reference import obj as ref_obj
    head = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
            "vn 0 0 1\n")
    path = tmp_path / "tri.obj"
    path.write_text(head + "f 1/1/1 2/2/1 3/3/1\n")
    pos, uv, nrm = ref_obj.load(path)
    assert pos.tolist() == [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    assert uv.tolist() == [[0, 0], [1, 0], [0, 1]]
    assert nrm.tolist() == [[0, 0, 1]] * 3
    for bad in ("f 1/1/1 2/2/1 3/3/1 1/1/1\n", "f 1//1 2//1 3//1\n",
                "f 1/1/1 2/2/1 9/3/1\n", "f -3/-3/-1 -2/-2/-1 -1/-1/-1\n"):
        path.write_text(head + bad)
        with pytest.raises(ValueError):
            ref_obj.load(path)


def test_gpubench_checkerboard_and_mips_equal_the_ports():
    from gpubench.harness import inputs
    from gpubench.reference import textures
    from metalrenderer_tpu_torch.io import textures as port_textures
    config, _, _ = files()
    (tex,) = config["textures"]
    base = inputs.mesh_arrays(config | {"instances": []})["textures"][0]
    theirs = port_textures.checkerboard(512, 16)
    assert len(theirs) == 10 and base.shape == (512, 512, 4)
    assert np.array_equal(base, theirs[0].numpy())
    assert tex == {"kind": "checkerboard", "size": 512, "squares": 16}
    ours = textures.from_array(base)
    program = port_textures.from_array(base, generate_mips=True)
    for a, b, c in zip(ours, theirs, program, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


def small_config():
    config, _, _ = files()
    config["render"].update(width=192, height=108)
    config["instances"][0]["mesh"]["target_tris"] = 4000
    return config


def program_and_reference(config, fi, tmp_path, texture_id=None):
    """(the port's split-path frame, the reference's frame and counts) of
    ``config`` at frame inputs ``fi``; ``texture_id`` overrides the
    reference's instance's."""
    from gpubench.harness import check, entries, inputs
    from metalrenderer_tpu_torch.passes import pipeline, prep
    arrays = inputs.mesh_arrays(config, tmp_path)
    scene, camera, lighting, render, shadow, target = entries.port_scene(
        config, arrays, "cpu")
    assert not prep.fused_ok(scene, lighting, render)
    camera = dataclasses.replace(camera, theta=fi["theta"])
    prog, _ = pipeline.render_frame(scene, camera, lighting, render, shadow,
                                    fi["displacement"], target, device="cpu")
    if texture_id is not None:
        config = json.loads(json.dumps(config))
        config["instances"][0]["texture_id"] = texture_id
    ref, counts = check.reference_frame(config,
                                        check.reference_arrays(arrays), fi,
                                        torch.device("cpu"), count=True)
    return prog, ref, counts


@pytest.mark.parametrize("frame", [0, 97])
def test_gpubench_config3_program_within_the_cells_limits(frame, tmp_path):
    """The port's ``render_frame`` on the CPU (the kernels' plain twins),
    its mesh loaded by ``io/obj`` from the harness's file, against the
    reference at two orbit frames."""
    from gpubench.harness import check, entries, inputs
    config = small_config()
    _, traffic, limits = files()
    fi = inputs.frames(traffic, config, frame, 1, 2 ** 36 + 3)[0]
    prog, ref, counts = program_and_reference(config, fi, tmp_path)
    frame_mae, tile_mae = check.frame_gaps(prog, ref)
    assert frame_mae <= limits["frame_mae"]
    assert tile_mae <= limits["tile_mae"]
    # The frame is what the cell is for: every shaded pixel textured, no
    # normal map and no shadow pass.
    assert 0 < counts["textured"] == counts["shaded"]
    assert counts["normal_mapped"] == 0 and counts["shadow"] == 0
    scene = entries.port_scene(config, inputs.mesh_arrays(config, tmp_path),
                               "cpu")[0]
    assert scene.instances[0].material.texture_id == 0


def test_gpubench_config3_without_the_texture_fails_the_limits(tmp_path):
    """The reference with the instance's texture taken away: the texture
    decides the pixel, so the program's frame is out of the limits."""
    from gpubench.harness import check, inputs
    config = small_config()
    _, traffic, limits = files()
    fi = inputs.frames(traffic, config, 0, 1, 2 ** 36 + 3)[0]
    prog, ref, counts = program_and_reference(config, fi, tmp_path,
                                              texture_id=-1)
    assert counts["textured"] == 0
    frame_mae, tile_mae = check.frame_gaps(prog, ref)
    assert frame_mae > limits["frame_mae"] or tile_mae > limits["tile_mae"]


def test_gpubench_config2_as_data_gives_the_ports_scene():
    """The port's ``config2_multi_mesh(seed=0)`` written out as a
    description (its draws repeated in its order): both sides give its
    model matrices and meshes bit for bit."""
    from gpubench.harness import entries, inputs
    from gpubench.reference import scene as ref_scene
    from metalrenderer_tpu_torch.engine import configs
    from metalrenderer_tpu_torch.scene import mesh
    rng = np.random.default_rng(0)
    instances = []
    for i in range(24):
        pos = rng.uniform(-4, 4, 3) * np.array([1, 0.4, 1]) + [0, 0.5, 0]
        s = rng.uniform(0.3, 0.9)
        angle = rng.uniform(0, np.pi)
        axis = rng.uniform(-1, 1, 3)
        instances.append({
            "mesh": ({"kind": "cube"} if i % 2 == 0 else
                     {"kind": "uv_sphere", "stacks": 12, "slices": 24}),
            "translate": pos.tolist(), "scale": [s, s, s],
            "rotate": {"angle": angle, "axis": axis.tolist()},
            "material": {"kind": "blinn_phong", "color": [1.0, 1.0, 1.0]}})
    instances.append({"mesh": {"kind": "plane"},
                      "translate": [0.0, -1.0, 0.0],
                      "scale": [10.0, 1.0, 10.0],
                      "material": {"kind": "blinn_phong",
                                   "color": [0.5, 0.7, 0.5]}})
    config = json.loads(json.dumps({
        "render": {"width": 64, "height": 48, "msaa": 4,
                   "shadow_map_size": 64},
        "camera": {"radius": 9.0, "theta": 2.4, "phi": 1.1},
        "light": {"kind": "point", "position": [0.0, 2.0, 0.0]},
        "instances": instances}))
    arrays = inputs.mesh_arrays(config)
    port, *_ = entries.port_scene(config, arrays, "cpu")
    ref, *_ = ref_scene.build(config, arrays)
    theirs, *_ = configs.config2_multi_mesh(width=64, height=48, seed=0,
                                            device="cpu")
    sphere = mesh.uv_sphere(stacks=12, slices=24)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(
        inputs.uv_sphere_arrays(12, 24),
        (sphere.positions, sphere.uvs, sphere.normals), strict=True))
    assert len(port.instances) == len(ref) == len(theirs.instances) == 25
    for p, r, t in zip(port.instances, ref, theirs.instances, strict=True):
        assert torch.equal(p.model_matrix, t.model_matrix)
        assert torch.equal(r.model_matrix, t.model_matrix)
        for f in ("positions", "uvs", "normals"):
            assert torch.equal(getattr(p.mesh, f), getattr(t.mesh, f))
            assert torch.equal(getattr(r.mesh, f), getattr(t.mesh, f))
