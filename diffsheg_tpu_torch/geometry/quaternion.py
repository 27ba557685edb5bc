"""Quaternion algebra + continuous 6D rotation representation (torch).

Counterpart of ``diffsheg_tpu/geometry/quaternion.py``: Hamilton product,
vector rotation, euler extraction, slerp, and the 6D continuous
representation, batched over leading dimensions on any device.
Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import math

import torch

from diffsheg_tpu_torch.geometry.rotations import (
    axis_angle_to_quaternion,
    quaternion_to_axis_angle,
    quaternion_to_matrix,
)

__all__ = [
    "qmul", "qinv", "qrot", "qeuler", "qslerp", "qnormalize", "qbetween",
    "axis_angle_to_quaternion", "quaternion_to_axis_angle",
    "matrix_to_cont6d", "cont6d_to_matrix", "quaternion_to_cont6d",
    "qfix", "qpow", "expmap_to_quaternion", "euler_to_quaternion",
]


def _norm(v: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q, 1e-8)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, (..., 4) each."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), via the
    cross-product form: v + 2 w (u x v) + 2 u x (u x v)."""
    u, w = q[..., 1:], q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def qeuler(q: torch.Tensor, order: str = "xyz", epsilon: float = 0.0
           ) -> torch.Tensor:
    """Unit quaternion -> euler angles for the six proper orders."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def clip(v):
        return torch.clamp(v, -1.0 + epsilon, 1.0 - epsilon)

    atan2, asin = torch.atan2, torch.asin
    if order == "xyz":
        e = (atan2(2 * (x * w - y * z), 1 - 2 * (x * x + y * y)),
             asin(clip(2 * (x * z + y * w))),
             atan2(2 * (z * w - x * y), 1 - 2 * (y * y + z * z)))
    elif order == "yzx":
        e = (asin(clip(2 * (x * w + y * z))),
             atan2(2 * (y * w - z * x), 1 - 2 * (x * x + y * y)),
             atan2(2 * (z * w - x * y), 1 - 2 * (x * x + z * z)))
    elif order == "zxy":
        e = (asin(clip(2 * (x * w + y * z))),
             atan2(2 * (y * w - x * z), 1 - 2 * (x * x + y * y)),
             atan2(2 * (z * w - x * y), 1 - 2 * (x * x + z * z)))
    elif order == "xzy":
        e = (atan2(2 * (x * w + y * z), 1 - 2 * (x * x + z * z)),
             atan2(2 * (y * w + x * z), 1 - 2 * (y * y + z * z)),
             asin(clip(2 * (z * w - x * y))))
    elif order == "yxz":
        e = (asin(clip(2 * (x * w - y * z))),
             atan2(2 * (x * z + y * w), 1 - 2 * (x * x + y * y)),
             atan2(2 * (x * y + z * w), 1 - 2 * (x * x + z * z)))
    elif order == "zyx":
        e = (atan2(2 * (x * w + y * z), 1 - 2 * (x * x + y * y)),
             asin(clip(2 * (y * w - x * z))),
             atan2(2 * (x * y + z * w), 1 - 2 * (y * y + z * z)))
    else:
        raise ValueError(order)
    return torch.stack(e, dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation with shortest-path sign flip."""
    q0, q1 = qnormalize(q0), qnormalize(q1)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.acos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Minimal rotation taking v0 to v1."""
    w = (torch.linalg.norm(v0, dim=-1, keepdim=True)
         * torch.linalg.norm(v1, dim=-1, keepdim=True)
         + torch.sum(v0 * v1, dim=-1, keepdim=True))
    return qnormalize(torch.cat([w, _cross(v0, v1)], dim=-1))


def matrix_to_cont6d(m: torch.Tensor) -> torch.Tensor:
    """First two matrix columns, flattened."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_cont6d(quaternion_to_matrix(q))


def cont6d_to_matrix(c: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt reconstruction."""
    a1, a2 = c[..., :3], c[..., 3:6]
    b1 = a1 / _norm(a1, 1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / _norm(b2, 1e-8)
    b3 = _cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the leading (time) axis: each frame's
    quaternion flipped to the hemisphere of its predecessor (cumulative
    parity).  (L, ..., 4) -> same shape."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)
    flip = (torch.cumsum((dots < 0).to(torch.int32), dim=0) % 2) == 1
    sign = 1.0 - 2.0 * flip.to(q.dtype)
    sign = torch.cat([torch.ones_like(sign[:1]), sign], dim=0)
    return q * sign[..., None]


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle (exponential map) (*, 3) -> quaternion (*, 4); the
    sinc-stable half-angle formula."""
    theta = torch.linalg.norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([w, xyz], dim=-1)


def euler_to_quaternion(e: torch.Tensor, order: str = "xyz",
                        degrees: bool = False) -> torch.Tensor:
    """Euler angles (*, 3) -> quaternion (*, 4), composing per-axis
    half-angle quaternions in ``order``; for the right-handed orders
    (xyz/yzx/zxy) the antipodal flip keeps the reference's sign."""
    if degrees:
        e = e * (math.pi / 180.0)
    half = 0.5 * e
    c, s = torch.cos(half), torch.sin(half)
    zero = torch.zeros_like(c[..., 0])
    axis_q = {
        "x": torch.stack([c[..., 0], s[..., 0], zero, zero], dim=-1),
        "y": torch.stack([c[..., 1], zero, s[..., 1], zero], dim=-1),
        "z": torch.stack([c[..., 2], zero, zero, s[..., 2]], dim=-1),
    }
    out = axis_q[order[0]]
    for axis in order[1:]:
        out = qmul(out, axis_q[axis])
    if order in ("xyz", "yzx", "zxy"):
        out = -out
    return out


def qpow(q: torch.Tensor, t) -> torch.Tensor:
    """Quaternion power q**t via the axis-angle logarithm; ``t``
    broadcasts against q[..., 0]; near-identity quaternions are
    epsilon-guarded."""
    q = qnormalize(q)
    theta0 = torch.acos(torch.clamp(q[..., 0], -1.0, 1.0))
    theta0 = torch.where(torch.abs(theta0) <= 1e-9,
                         torch.full_like(theta0, 1e-9), theta0)
    v0 = q[..., 1:] / torch.sin(theta0)[..., None]
    theta = torch.as_tensor(t, dtype=q.dtype, device=q.device) * theta0
    return torch.cat(
        [torch.cos(theta)[..., None], v0 * torch.sin(theta)[..., None]],
        dim=-1)
