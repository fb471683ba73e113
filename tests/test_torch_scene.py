"""Port parity, scene side: transforms, camera, lights, bake and project of
metalrenderer_tpu_torch against metalrenderer_tpu on the same inputs.

Tolerance: rtol = atol = 1e-6 for floats. Both sides compute in f32, but
XLA:CPU evaluates sin/cos/tan with its own approximations and contracts
multiply-adds into FMAs, while the port rounds every eager op; the results
agree to a few f32 ULPs. Integers, flags and exact constructions (meshes,
translation/scale matrices) must be equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.engine import audio_app as j_app
from metalrenderer_tpu.math import transforms as j_tf
from metalrenderer_tpu.scene import camera as j_cam
from metalrenderer_tpu.scene import lights as j_lights
from metalrenderer_tpu.scene import mesh as j_mesh
from metalrenderer_tpu.scene import scene as j_scene

from metalrenderer_tpu_torch import convert
from metalrenderer_tpu_torch.engine import audio_app
from metalrenderer_tpu_torch.math import transforms
from metalrenderer_tpu_torch.scene import camera, lights, mesh, scene

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_mesh_builders_equal():
    for pm, jm in ((mesh.cube(), j_mesh.cube()), (mesh.plane(), j_mesh.plane())):
        for f in ("positions", "uvs", "normals"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(),
                                          np.asarray(getattr(jm, f)))


def test_matrix_builders_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        fov, aspect = rng.uniform(0.3, 1.5), rng.uniform(0.5, 2.5)
        near, far = rng.uniform(0.01, 1.0), rng.uniform(10.0, 200.0)
        _close(transforms.perspective_rh(np.float32(fov), np.float32(aspect),
                                         np.float32(near), np.float32(far)),
               j_tf.perspective_rh(jnp.float32(fov), jnp.float32(aspect),
                                   jnp.float32(near), jnp.float32(far)))
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        np.testing.assert_array_equal(transforms.translation(*t).numpy(),
                                      np.asarray(j_tf.translation(*t)))
        np.testing.assert_array_equal(transforms.scale(*t).numpy(),
                                      np.asarray(j_tf.scale(*t)))
        eye, target = rng.uniform(-5, 5, (2, 3)).astype(np.float32)
        _close(transforms.look_at_rh(eye, target, (0.0, 1.0, 0.0)),
               j_tf.look_at_rh(eye, target, (0.0, 1.0, 0.0)))
    np.testing.assert_array_equal(
        transforms.ortho_rh(-8.0, 8.0, -8.0, 8.0, 0.1, 15.0).numpy(),
        np.asarray(j_tf.ortho_rh(-8.0, 8.0, -8.0, 8.0, 0.1, 15.0)))


def test_point_and_direction_transforms_match():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((4, 4)).astype(np.float32)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    _close(transforms.transform_points(torch.from_numpy(m),
                                       torch.from_numpy(pts)),
           j_tf.transform_points(jnp.asarray(m), jnp.asarray(pts)))
    _close(transforms.transform_dirs(torch.from_numpy(m[:3, :3]),
                                     torch.from_numpy(pts)),
           j_tf.transform_dirs(jnp.asarray(m[:3, :3]), jnp.asarray(pts)))
    _close(transforms.normalize(torch.from_numpy(pts)),
           j_tf.normalize(jnp.asarray(pts)))


@pytest.mark.parametrize("params", [
    dict(radius=5.0, theta=2.5, phi=1.2, aspect=96 / 72),
    dict(radius=2.0, theta=3.14, phi=1.57, aspect=1.0),
    dict(radius=7.5, theta=-0.7, phi=0.2, aspect=16 / 9,
         target=(0.5, -0.25, 1.0)),
])
def test_orbit_camera_matches(params):
    jc = j_cam.OrbitCamera(**params)
    pc = convert.camera_from_jax(jc)
    assert isinstance(pc, camera.OrbitCamera)
    _close(pc.position, jc.position)
    _close(pc.view_matrix(), jc.view_matrix())
    _close(pc.projection_matrix(), jc.projection_matrix())


def test_light_matrices_match():
    rng = np.random.default_rng(2)
    for _ in range(8):
        pos, target = rng.uniform(-4, 4, (2, 3)).astype(np.float32)
        fwd = j_tf.normalize(jnp.asarray(target - pos))
        np.testing.assert_array_equal(
            lights.adaptive_up(convert.tensor(fwd)).numpy(),
            np.asarray(j_lights.adaptive_up(fwd)))
        _close(lights.light_view_matrix(pos, target),
               j_lights.light_view_matrix(pos, target))
    np.testing.assert_array_equal(lights.light_projection_matrix().numpy(),
                                  np.asarray(j_lights.light_projection_matrix()))
    lp = lights.light_anchor_position(lights.PointLight(), (0.0, 0.0, -1.0))
    np.testing.assert_array_equal(lp.numpy(), [0.0, 2.0, 0.0])


def test_build_scene_equals_converted_jax_scene():
    ported = audio_app.build_scene(device="cpu")
    converted = convert.scene_from_jax(j_app.build_scene())
    assert len(ported.instances) == len(converted.instances) == 3
    for a, b in zip(ported.instances, converted.instances):
        assert (a.cast_shadow, a.use_displacement) == \
            (b.cast_shadow, b.use_displacement)
        assert (a.material.kind, a.material.texture_id,
                a.material.normal_map_id) == \
            (b.material.kind, b.material.texture_id, b.material.normal_map_id)
        for x, y in ((a.model_matrix, b.model_matrix),
                     (a.material.color, b.material.color),
                     (a.mesh.positions, b.mesh.positions),
                     (a.mesh.uvs, b.mesh.uvs),
                     (a.mesh.normals, b.mesh.normals)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("displacement", [0.0, 0.03])
def test_bake_and_project_match(displacement):
    js = j_app.build_scene()
    jg = j_scene.bake(js, displacement)
    pg = scene.bake(convert.scene_from_jax(js), np.float32(displacement))
    for f in ("mat_kind", "tex_id", "normal_map_id", "cast_shadow"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    np.testing.assert_array_equal(pg.mat_color.numpy(), np.asarray(jg.mat_color))
    np.testing.assert_array_equal(pg.uvs.numpy(), np.asarray(jg.uvs))
    _close(pg.world, jg.world)
    _close(pg.normals, jg.normals)

    jc = j_cam.OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=4 / 3)
    pc = convert.camera_from_jax(jc)
    world = convert.tensor(jg.world)
    # Same world positions and matrices in: only the product is compared.
    clip = scene.project(world, convert.tensor(jc.view_matrix()),
                         convert.tensor(jc.projection_matrix()))
    _close(clip, j_scene.project(jg.world, jc.view_matrix(),
                                 jc.projection_matrix()))
    # And the whole vertex stage from the port's own camera matrices.
    clip2 = scene.project(pg.world, pc.view_matrix(), pc.projection_matrix())
    _close(clip2, j_scene.project(jg.world, jc.view_matrix(),
                                  jc.projection_matrix()))
