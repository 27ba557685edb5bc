"""Rotation-representation conversions, vectorized in torch.

Counterpart of ``diffsheg_tpu/geometry/rotations.py``, the same names and
the same math on tensors of any device: euler <-> matrix <-> quaternion <->
axis-angle, branch-free (``torch.where`` selects, both sides finite), so
the export's axis-angle -> euler-degree conversion
(``sampling/export.py``) runs on the card in one batch.

Conventions (matching the reference):
  - quaternions are (w, x, y, z), real part first;
  - euler angles are intrinsic rotations applied in the convention string's
    order, i.e. ``"XYZ"`` means ``R = Rx(a) @ Ry(b) @ Rz(c)``;
  - axis-angle magnitude is the rotation angle in radians.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _axis_rotation_matrix(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about a principal axis; angle shape (...,) -> (...,3,3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"bad axis {axis!r}")
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """(..., 3) euler radians -> (..., 3, 3) rotation matrices."""
    if len(convention) != 3:
        raise ValueError(convention)
    m = _axis_rotation_matrix(convention[0], euler[..., 0])
    for i in (1, 2):
        m = m @ _axis_rotation_matrix(convention[i], euler[..., i])
    return m


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz.  Branch-free Shepperd-style selection:
    all four candidate quaternions, the one keyed on the largest squared
    component gathered (the first on a tie, as ``jnp.argmax``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # 4*q_i^2 for i in (w, x, y, z)
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    # candidate quaternions, one per dominant component
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1, keepdim=True)            # (..., 1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)               # (..., 4, 4)
    idx = best[..., None].expand(best.shape[:-1] + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    denom = 2.0 * _safe_sqrt(torch.gather(mags, -1, best))
    q = q / torch.clamp(denom, min=_EPS)
    # canonical sign: non-negative real part
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )
    return torch.stack(rows, dim=-1).reshape(q.shape[:-1] + (3, 3))


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3) axis*angle.  Taylor fallback for tiny
    angles; the double ``where`` keeps both sides finite."""
    norm = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norm, q[..., :1])
    angle = 2.0 * half
    small = torch.abs(angle) < _EPS
    one = torch.ones_like(angle)
    # sin(x/2)/x ~= 1/2 - x^2/48 near zero
    ratio = torch.where(
        small,
        0.5 - angle * angle / 48.0,
        torch.sin(torch.where(small, one, half)) / torch.where(small, one, angle),
    )
    return q[..., 1:] / ratio


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) wxyz."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = torch.abs(angle) < _EPS
    ratio = torch.where(
        small,
        0.5 - angle * angle / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle),
    )
    return torch.cat([torch.cos(half), aa * ratio], dim=-1)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def euler_to_axis_angle(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    return matrix_to_axis_angle(euler_to_matrix(euler, convention))


def _index_of(letter: str) -> int:
    return "XYZ".index(letter)


def matrix_to_euler(m: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) euler radians, intrinsic ``convention``.
    Near gimbal lock (|m[i0, i2]| -> 1) the split between the first and
    third angle is ill-conditioned; the rebuilt matrix is not."""
    i0, i2 = _index_of(convention[0]), _index_of(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            m[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0),
            -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(m[..., i0, i0], -1.0, 1.0))

    def angle_from_tan(axis, other_axis, data, horizontal):
        # ``data`` is column i2 (vertical) or row i0 (horizontal) of m.
        i1, i2_ = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
        if horizontal:
            i1, i2_ = i2_, i1
        even = axis + other_axis in ("XY", "YZ", "ZX")
        if horizontal == even:
            return torch.atan2(data[..., i1], data[..., i2_])
        if tait_bryan:
            return torch.atan2(-data[..., i2_], data[..., i1])
        return torch.atan2(data[..., i2_], -data[..., i1])

    o0 = angle_from_tan(convention[0], convention[1], m[..., :, i2], False)
    o2 = angle_from_tan(convention[2], convention[1], m[..., i0, :], True)
    return torch.stack([o0, central, o2], dim=-1)


def axis_angle_to_euler(aa: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """The export's conversion (reference rotation_converter.py:282-297)."""
    return matrix_to_euler(axis_angle_to_matrix(aa), convention)
