"""Quaternion suite (torch counterpart of
``metalrenderer_tpu.math.quaternion``), the reference's quaternion library
(AAPLMathUtilities.h:190-266). Quaternions are f32 tensors ``[..., 4]`` in
``(x, y, z, w)`` order (imaginary first, the reference's ``vector_float4``
convention: w + xi + yj + zk).

Plain functions that broadcast over leading axes, in the JAX package's
order of operations. Sums over the last axis are written out left to right,
so every device rounds them alike.
"""
from __future__ import annotations

import torch

from .transforms import cross

F32 = torch.float32


def _f32(x):
    return torch.as_tensor(x, dtype=F32)


def _sum_last(p):
    """Sum over the last axis, left to right."""
    out = p[..., 0]
    for k in range(1, p.shape[-1]):
        out = out + p[..., k]
    return out


def _norm(v, keepdim=False):
    n = torch.sqrt(_sum_last(v * v))
    return n.unsqueeze(-1) if keepdim else n


def identity():
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32)


def from_axis_angle(axis, radians):
    """quaternion(radians, axis) — AAPLMathUtilities.h:203."""
    axis = _f32(axis)
    axis = axis / _norm(axis, keepdim=True)
    half = _f32(radians) * 0.5
    s = torch.sin(half).unsqueeze(-1)
    return torch.cat([axis * s, torch.cos(half).unsqueeze(-1)], dim=-1)


def from_euler(euler):
    """quaternion_from_euler (AAPLMathUtilities.h:231): XYZ intrinsic order."""
    euler = _f32(euler)
    hx, hy, hz = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cx, sx = torch.cos(hx), torch.sin(hx)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cz, sz = torch.cos(hz), torch.sin(hz)
    return torch.stack([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ], dim=-1)


def length(q):
    return _norm(q)


def normalize(q):
    return q / _norm(q, keepdim=True)


def conjugate(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def inverse(q):
    return conjugate(q) / _sum_last(q * q).unsqueeze(-1)


def multiply(q0, q1):
    """Hamilton product q0*q1 (quaternion_multiply)."""
    x0, y0, z0, w0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    return torch.stack([
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
    ], dim=-1)


def rotate_vector(q, v):
    """quaternion_rotate_vector: v' = q v q*."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def axis(q):
    """Rotation axis of a unit quaternion (quaternion_axis)."""
    s = torch.sqrt(torch.clamp_min(1.0 - q[..., 3:4] ** 2, 1e-20))
    return q[..., :3] / s


def angle(q):
    """Rotation angle of a unit quaternion (quaternion_angle)."""
    return 2.0 * torch.arccos(torch.clamp(q[..., 3], -1.0, 1.0))


def slerp(q0, q1, t):
    """Spherical linear interpolation (quaternion_slerp)."""
    t = _f32(t)
    d = _sum_last(q0 * q1).unsqueeze(-1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return normalize(w0 * q0 + w1 * q1)


def to_matrix3x3(q):
    """matrix3x3_from_quaternion (AAPLMathUtilities.h:54)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def to_matrix4x4(q):
    """matrix4x4_from_quaternion (AAPLMathUtilities.h:99)."""
    m3 = to_matrix3x3(q)
    m = torch.zeros(m3.shape[:-2] + (4, 4), dtype=m3.dtype, device=m3.device)
    m[..., :3, :3] = m3
    m[..., 3, 3] = 1.0
    return m


def from_matrix3x3(m):
    """quaternion_from_matrix3x3 — Shepperd's method, branch-free.

    Computes all four major-component candidates (w/x/y/z) with
    S_k = 2*sqrt(score_k) and picks the one with the largest score (the
    first on a tie), which keeps the divisor well away from zero for any
    proper rotation.
    """
    m = _f32(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    scores = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp_min(scores, 1e-20))
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cand = torch.stack([
        torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                     0.25 * s0], dim=-1),
        torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                     (m21 - m12) / s1], dim=-1),
        torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                     (m02 - m20) / s2], dim=-1),
        torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                     (m10 - m01) / s3], dim=-1),
    ], dim=-2)                                       # [..., 4 cand, 4 comp]
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return normalize(q)
