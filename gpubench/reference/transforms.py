"""Matrix/transform library with the reference's conventions.

A frozen copy of the port's ``math/transforms.py`` for the benchmark's
reference. Matrices are
row-major ``f32[4,4]`` tensors acting on column vectors (``clip = P @ V @ M
@ pos``), exactly as there:
  * right-handed view space, camera looks down -Z;
  * perspective with Metal's NDC z in [0, 1] (mtl_engine.hpp:86-95);
  * ortho RH with z in [0, 1] (AAPLMathUtilities.cpp:349-355);
  * look_at RH (AAPLMathUtilities.cpp:317-329 / Camera.cpp:52-71).

Every product here is written out as a sequence of separate f32 multiplies
and adds in a fixed order (``matmul``), never a BLAS call: the result is then
bit-identical on the CPU and on the GPU, and no TF32 or FMA rounding can
enter geometry whose signs decide pixel coverage.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _f32(x):
    return torch.as_tensor(x, dtype=F32)


def matmul(a, b):
    """``a @ b`` for [..., K] x [K, N] as an explicit left-to-right sum over
    K of separately rounded products (device-independent rounding)."""
    out = a[..., 0:1] * b[0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k:k + 1] * b[k]
    return out


def dot3(a, b):
    """Dot product over the last axis of 3-vectors, ((x + y) + z) order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def perspective_rh(fovy_radians, aspect, near, far):
    """Right-handed perspective, Metal z in [0,1] clip convention
    (``MtlEngine::matrix_perspective_right_hand``, mtl_engine.hpp:86-95)::

        ys = 1 / tan(fovy/2);  xs = ys / aspect;  zs = far / (near - far)
        rows: [xs 0 0 0; 0 ys 0 0; 0 0 zs near*zs; 0 0 -1 0]
    """
    fovy = _f32(fovy_radians)
    ys = 1.0 / torch.tan(fovy * 0.5)
    xs = ys / _f32(aspect)
    near, far = _f32(near), _f32(far)
    zs = far / (near - far)
    z = torch.zeros((), dtype=F32)
    o = torch.ones((), dtype=F32)
    return torch.stack([
        torch.stack([xs, z, z, z]),
        torch.stack([z, ys, z, z]),
        torch.stack([z, z, zs, near * zs]),
        torch.stack([z, z, -o, z]),
    ])


def ortho_rh(left, right, bottom, top, near, far):
    """Right-handed orthographic projection, z in [0,1]
    (``matrix_ortho_right_hand``, AAPLMathUtilities.cpp:349-355)."""
    return torch.tensor(
        [
            [2.0 / (right - left), 0, 0, (left + right) / (left - right)],
            [0, 2.0 / (top - bottom), 0, (top + bottom) / (bottom - top)],
            [0, 0, -1.0 / (far - near), near / (near - far)],
            [0, 0, 0, 1.0],
        ],
        dtype=F32,
    )


def normalize(v, eps=0.0):
    n = torch.sqrt(dot3(v, v)).unsqueeze(-1)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (AAPLMathUtilities.cpp:317-329)::

        z = normalize(eye - target); x = normalize(cross(up, z)); y = cross(z, x)
        rows: [x -dot(x,eye); y -dot(y,eye); z -dot(z,eye); 0 0 0 1]
    """
    eye, target, up = _f32(eye), _f32(target), _f32(up)
    z = normalize(eye - target)
    x = normalize(cross(up, z))
    y = cross(z, x)
    t = torch.stack([-dot3(x, eye), -dot3(y, eye), -dot3(z, eye)])
    return torch.stack([
        torch.cat([x, t[0:1]]),
        torch.cat([y, t[1:2]]),
        torch.cat([z, t[2:3]]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32),
    ])


def translation(tx, ty, tz):
    """``matrix4x4_translation`` (AAPLMathUtilities.cpp:271-276)."""
    m = torch.eye(4, dtype=F32)
    m[:3, 3] = torch.stack([_f32(tx), _f32(ty), _f32(tz)])
    return m


def scale(sx, sy, sz):
    """``matrix4x4_scale`` (AAPLMathUtilities.cpp:257-262)."""
    return torch.diag(torch.stack([_f32(sx), _f32(sy), _f32(sz),
                                   torch.ones((), dtype=F32)]))


def rotation(radians, axis):
    """Axis-angle rotation (``matrix4x4_rotation``,
    AAPLMathUtilities.cpp:233-244). The angle and the axis are taken as f32
    first, as the JAX package takes them, then cos and sin."""
    axis = normalize(_f32(axis))
    x, y, z = axis[0], axis[1], axis[2]
    rad = _f32(radians)
    ct = torch.cos(rad)
    st = torch.sin(rad)
    ci = 1.0 - ct
    zero = torch.zeros((), dtype=F32)
    return torch.stack([
        torch.stack([ct + x * x * ci, x * y * ci - z * st,
                     x * z * ci + y * st, zero]),
        torch.stack([y * x * ci + z * st, ct + y * y * ci,
                     y * z * ci - x * st, zero]),
        torch.stack([z * x * ci - y * st, z * y * ci + x * st,
                     ct + z * z * ci, zero]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32),
    ])


def upper_left_3x3(m):
    """First 3 columns/rows of a 4x4 model matrix — the reference's "normal
    matrix" (BlinnPhong.metal:21; NOT an inverse-transpose)."""
    return m[:3, :3]


def inverse_transpose_3x3(m3):
    """``matrix_inverse_transpose`` (AAPLMathUtilities.cpp:197ff), for
    normal transforms under non-uniform scale: the cofactor matrix over the
    determinant, written out (no LAPACK call, the same rounding on every
    device)."""
    def c(i, j):
        r0, r1 = [r for r in range(3) if r != i]
        c0, c1 = [k for k in range(3) if k != j]
        minor = m3[r0, c0] * m3[r1, c1] - m3[r0, c1] * m3[r1, c0]
        return minor if (i + j) % 2 == 0 else -minor
    cof = torch.stack([torch.stack([c(i, j) for j in range(3)])
                       for i in range(3)])
    det = (m3[0, 0] * cof[0, 0] + m3[0, 1] * cof[0, 1]) + m3[0, 2] * cof[0, 2]
    return cof / det


def transform_points(m, pts):
    """Apply a 4x4 to an [N,4] (or [N,3] homogenized) point array -> [N,4]."""
    if pts.shape[-1] == 3:
        pts = torch.cat([pts, torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                                         device=pts.device)], dim=-1)
    return matmul(pts, m.T)


def transform_dirs(m3, dirs):
    """Apply a 3x3 to an [N,3] direction array."""
    return matmul(dirs, m3.T)

