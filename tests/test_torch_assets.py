"""Port parity, the rest of the scene layer and the OBJ asset path: the
legacy meshes and the UV sphere, ``concatenate``, ``rotation``,
``inverse_transpose_3x3``, ``sample_nearest``, and ``io/obj.py`` with the
native parser (``io/native.py``) against metalrenderer_tpu on the same
inputs.

Bars: meshes and loaded arrays bit-equal (both sides build and parse in
numpy float32, and save_obj writes each float32 in its shortest round-trip
form). Matrices within 1e-6 absolute: both sides compute in f32, but XLA:CPU
evaluates cos and sin with its own approximations and the axis norm with
FMAs, while the port rounds every eager op (rotation entries lie in [-1, 1];
measured 4.8e-7 at most over 2,000 seeded angles and axes). The inverse
transpose within 1e-6 of its largest entry: LAPACK's LU there, the
cofactors over the determinant here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metalrenderer_tpu.io import obj as j_obj
from metalrenderer_tpu.math import transforms as j_tf
from metalrenderer_tpu.raster import sampling as j_sampling
from metalrenderer_tpu.scene import mesh as j_mesh

from metalrenderer_tpu_torch import square, triangle, uv_sphere
from metalrenderer_tpu_torch.engine import configs
from metalrenderer_tpu_torch.io import native, obj
from metalrenderer_tpu_torch.math import transforms
from metalrenderer_tpu_torch.raster import sampling
from metalrenderer_tpu_torch.scene import mesh

torch.set_num_threads(2)
FIELDS = ("positions", "uvs", "normals")


def _bits_equal(port, ref):
    """Every field of two meshes (port: torch, ref: anything numpy reads)
    equal bit for bit."""
    for f in FIELDS:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype == np.float32, f
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f)


@pytest.mark.parametrize("name", ["triangle", "square", "uv_sphere_12x24",
                                  "uv_sphere_default", "concatenate"])
def test_mesh_builders_bit_equal(name):
    port, ref = {
        "triangle": (triangle, j_mesh.triangle),
        "square": (square, j_mesh.square),
        "uv_sphere_12x24": (lambda: uv_sphere(12, 24),
                            lambda: j_mesh.uv_sphere(12, 24)),
        "uv_sphere_default": (uv_sphere, j_mesh.uv_sphere),
        "concatenate": (
            lambda: mesh.concatenate([mesh.cube(), uv_sphere(4, 6),
                                      triangle()]),
            lambda: j_mesh.concatenate([j_mesh.cube(),
                                        j_mesh.uv_sphere(4, 6),
                                        j_mesh.triangle()])),
    }[name]
    p, r = port(), ref()
    _bits_equal(p, r)
    assert p.num_vertices == r.num_vertices == 3 * p.num_triangles
    assert p.num_triangles == r.num_triangles


def test_uv_sphere_on_device_and_counts():
    m = uv_sphere(12, 24, radius=2.0, device="cpu")
    # 12 stacks of 24 quads, one triangle each in the two pole rows.
    assert m.num_triangles == 24 * (2 * 12 - 2)
    np.testing.assert_allclose(torch.linalg.norm(m.positions, dim=1).numpy(),
                               2.0, rtol=1e-6)


def test_rotation_matches_jax():
    rng = np.random.default_rng(5)
    worst = 0.0
    for _ in range(200):
        angle = rng.uniform(-2 * np.pi, 2 * np.pi)
        axis = rng.uniform(-1, 1, 3)        # float64, as config 2 passes it
        port = transforms.rotation(angle, axis)
        ref = np.asarray(j_tf.rotation(angle, jnp.asarray(axis)))
        assert port.dtype == torch.float32 and port.shape == (4, 4)
        worst = max(worst, float(np.abs(port.numpy() - ref).max()))
        np.testing.assert_array_equal(port.numpy()[3], [0, 0, 0, 1])
        np.testing.assert_array_equal(port.numpy()[:3, 3], 0)
    assert worst <= 1e-6, worst
    # A quarter turn about z takes x to y.
    r = transforms.rotation(np.pi / 2, (0.0, 0.0, 2.0))
    np.testing.assert_allclose(transforms.transform_points(
        r, torch.tensor([[1.0, 0.0, 0.0]]))[0, :3].numpy(), [0, 1, 0],
        atol=1e-7)


def test_inverse_transpose_matches_jax():
    rng = np.random.default_rng(6)
    for _ in range(50):
        # A model matrix's upper 3x3: rotation times non-uniform scale.
        r = transforms.rotation(rng.uniform(0, np.pi), rng.uniform(-1, 1, 3))
        s = rng.uniform(0.3, 3.0, 3)
        m3 = transforms.matmul(r, transforms.scale(*s))[:3, :3].contiguous()
        port = transforms.inverse_transpose_3x3(m3)
        ref = np.asarray(j_tf.inverse_transpose_3x3(jnp.asarray(m3.numpy())))
        scale_ = np.abs(ref).max()
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-6 * scale_)
        # inv(M)^T M^T = I.
        np.testing.assert_allclose(
            transforms.matmul(port, m3.T).numpy(), np.eye(3), atol=2e-6)


@pytest.mark.parametrize("mode", [sampling.REPEAT, sampling.CLAMP])
def test_sample_nearest_matches_jax(mode):
    rng = np.random.default_rng(7)
    tex = rng.uniform(0, 1, (7, 5, 3)).astype(np.float32)
    u, v = rng.uniform(-2.0, 3.0, (2, 40, 30)).astype(np.float32)
    # Texel edges exactly, and both ends of the unit square.
    u[0, :6] = np.array([0.0, 0.2, 0.4, 1.0, -0.2, 1.2], np.float32)
    v[0, :6] = np.array([0.0, 1 / 7, 2 / 7, 1.0, -1 / 7, 8 / 7], np.float32)
    out = sampling.sample_nearest(torch.from_numpy(tex), torch.from_numpy(u),
                                  torch.from_numpy(v), mode)
    ref = j_sampling.sample_nearest(jnp.asarray(tex), jnp.asarray(u),
                                    jnp.asarray(v), mode)
    assert out.shape == (40, 30, 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_native_parser_builds_under_the_package():
    assert native.native_available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert path.parent.name.startswith("objparser-")


@pytest.mark.parametrize("use_native", [True, False])
def test_obj_roundtrip_bit_equal(tmp_path, use_native):
    """save_obj -> load_obj gives the saved mesh bit for bit, for the cube
    and for config 3's dense sphere, through either parser."""
    for name, m in (("cube", mesh.cube()),
                    ("sphere", configs._dense_sphere_mesh(5000))):
        p = tmp_path / f"{name}.obj"
        obj.save_obj(p, m)
        back = obj.load_obj(p, use_native=use_native)
        _bits_equal(back, m)
    assert back.num_triangles == 4900


@pytest.mark.parametrize("use_native", [True, False])
def test_obj_quad_fan_triangulation(tmp_path, use_native):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    m = obj.load_obj(p, use_native=use_native)
    assert m.num_triangles == 2
    # Fan from the first corner: (1, 2, 3), (1, 3, 4).
    np.testing.assert_array_equal(
        m.positions.numpy(), [[0, 0, 0], [1, 0, 0], [1, 1, 0],
                              [0, 0, 0], [1, 1, 0], [0, 1, 0]])
    # Generated flat normals point +Z (CCW quad).
    np.testing.assert_allclose(m.normals.numpy(), np.tile([0, 0, 1], (6, 1)),
                               atol=1e-6)


@pytest.mark.parametrize("use_native", [True, False])
def test_obj_loaders_equal_jax(tmp_path, use_native):
    """The port's and the JAX package's loaders give equal arrays on the
    same files: config 3's sphere as save_obj writes it, and a hand-written
    file with a pentagon, negative (relative) indices, corners without uv,
    and no normals (flat normals from the face planes)."""
    sphere = tmp_path / "sphere.obj"
    obj.save_obj(sphere, configs._dense_sphere_mesh(2000))
    odd = tmp_path / "odd.obj"
    odd.write_text(
        "# comment\nv 0 0 0\nv 1 0 0\nv 1.5 0.8 0.1\nv 0.5 1.5 0.2\n"
        "v -0.5 0.8 0.1\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "f 1/1 2/2 3/3 4 5\nf -5/-3 -4/-2 -3/-1\nf 2 4 3\n")
    for p in (sphere, odd):
        port = obj.load_obj(p, use_native=use_native)
        ref = j_obj.load_obj(p, use_native=use_native)
        _bits_equal(port, ref)
    assert port.num_triangles == 5
