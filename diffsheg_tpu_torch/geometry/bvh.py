"""BVH motion-capture file IO + vectorized forward kinematics.

The port's own copy of ``diffsheg_tpu/geometry/bvh.py`` (numpy only).

Replaces the reference's vendored pymo toolkit (reference datasets/pymo/
parsers.py:53, writers.py:4, preprocessing.py:14 MocapParameterizer) and its
template-rewrite output path (trainers/ddpm_beat_trainer.py:1386-1427) with a
compact host-side implementation:

  - :func:`parse_bvh` — hierarchy + channel spec + motion frames (numpy);
  - :func:`write_bvh` — serialize a skeleton + frames back to BVH text;
  - :func:`forward_kinematics` — euler-degree frames -> world-space joint
    positions, fully vectorized over frames (pymo walks a pandas DataFrame
    per frame; here it is one einsum chain along the joint hierarchy);
  - :func:`rewrite_template` — write generated 141-channel euler output into
    a full-skeleton template BVH in one vectorized scatter.

Parsing is line-oriented and tolerant of the BEAT exports' formatting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from diffsheg_tpu_torch.geometry.joints import (
    SPINE_NECK_141_IN_BEAT,
    scatter_subset_into_full,
)

_AXIS_OF = {"Xrotation": "X", "Yrotation": "Y", "Zrotation": "Z"}


@dataclasses.dataclass
class BvhJoint:
    name: str
    parent: int                      # -1 for root
    offset: np.ndarray               # (3,)
    channels: List[str]              # e.g. ['Zrotation','Xrotation','Yrotation']
    channel_start: int               # index into the flat frame vector
    is_end_site: bool = False


@dataclasses.dataclass
class BvhData:
    joints: List[BvhJoint]
    frames: np.ndarray               # (T, total_channels) float64
    frame_time: float

    @property
    def names(self) -> List[str]:
        return [j.name for j in self.joints if not j.is_end_site]

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time

    def rotation_order(self, joint: BvhJoint) -> str:
        return "".join(_AXIS_OF[c] for c in joint.channels if c in _AXIS_OF)


def parse_bvh(text: str) -> BvhData:
    """Parse BVH text into hierarchy + motion arrays."""
    lines = text.splitlines()
    i = 0
    joints: List[BvhJoint] = []
    stack: List[int] = []
    channel_cursor = 0
    n_end_sites = 0

    def tokens() -> List[str]:
        return lines[i].split()

    while i < len(lines) and "MOTION" not in lines[i]:
        tok = tokens()
        if not tok:
            i += 1
            continue
        key = tok[0]
        if key in ("ROOT", "JOINT"):
            joints.append(BvhJoint(
                name=tok[1],
                parent=stack[-1] if stack else -1,
                offset=np.zeros(3),
                channels=[],
                channel_start=channel_cursor,
            ))
        elif key == "End":
            n_end_sites += 1
            joints.append(BvhJoint(
                name=f"{joints[stack[-1]].name}_End{n_end_sites}",
                parent=stack[-1],
                offset=np.zeros(3),
                channels=[],
                channel_start=channel_cursor,
                is_end_site=True,
            ))
        elif key == "{":
            stack.append(len(joints) - 1)
        elif key == "}":
            stack.pop()
        elif key == "OFFSET":
            joints[stack[-1]].offset = np.array([float(v) for v in tok[1:4]])
        elif key == "CHANNELS":
            n = int(tok[1])
            joints[stack[-1]].channels = tok[2:2 + n]
            joints[stack[-1]].channel_start = channel_cursor
            channel_cursor += n
        i += 1

    # MOTION block
    while i < len(lines) and "Frames:" not in lines[i]:
        i += 1
    n_frames = int(lines[i].split(":")[1])
    i += 1
    frame_time = float(lines[i].split(":")[1])
    i += 1
    frames = np.loadtxt(lines[i:i + n_frames], dtype=np.float64, ndmin=2)
    assert frames.shape == (n_frames, channel_cursor), (
        frames.shape, n_frames, channel_cursor)
    return BvhData(joints=joints, frames=frames, frame_time=frame_time)


def parse_bvh_file(path: str) -> BvhData:
    with open(path) as f:
        return parse_bvh(f.read())


def write_bvh(data: BvhData, float_fmt: str = "%.6f") -> str:
    """Serialize back to BVH text (reference pymo/writers.py:4)."""
    out: List[str] = ["HIERARCHY"]
    children: Dict[int, List[int]] = {}
    for idx, j in enumerate(data.joints):
        children.setdefault(j.parent, []).append(idx)

    def emit(idx: int, depth: int) -> None:
        j = data.joints[idx]
        pad = "  " * depth
        if j.is_end_site:
            out.append(f"{pad}End Site")
        elif j.parent < 0:
            out.append(f"{pad}ROOT {j.name}")
        else:
            out.append(f"{pad}JOINT {j.name}")
        out.append(f"{pad}{{")
        off = " ".join(float_fmt % v for v in j.offset)
        out.append(f"{pad}  OFFSET {off}")
        if not j.is_end_site:
            out.append(f"{pad}  CHANNELS {len(j.channels)} "
                       + " ".join(j.channels))
        for c in children.get(idx, []):
            emit(c, depth + 1)
        out.append(f"{pad}}}")

    emit(0, 0)
    out.append("MOTION")
    out.append(f"Frames: {data.frames.shape[0]}")
    out.append(f"Frame Time: {data.frame_time:.8f}")
    for row in data.frames:
        out.append(" ".join(float_fmt % v for v in row))
    return "\n".join(out) + "\n"


def _euler_deg_to_matrix_np(euler_deg: np.ndarray, order: str) -> np.ndarray:
    """(..., 3) euler degrees in channel order ``order`` -> (..., 3, 3).
    BVH semantics: channels apply left-to-right, R = R_o0 @ R_o1 @ R_o2."""
    rad = np.deg2rad(euler_deg)
    m = np.broadcast_to(np.eye(3), euler_deg.shape[:-1] + (3, 3)).copy()
    for k, axis in enumerate(order):
        a = rad[..., k]
        c, s = np.cos(a), np.sin(a)
        zero, one = np.zeros_like(a), np.ones_like(a)
        if axis == "X":
            rows = (one, zero, zero, zero, c, -s, zero, s, c)
        elif axis == "Y":
            rows = (c, zero, s, zero, one, zero, -s, zero, c)
        else:
            rows = (c, -s, zero, s, c, zero, zero, zero, one)
        r = np.stack(rows, axis=-1).reshape(a.shape + (3, 3))
        m = m @ r
    return m


def forward_kinematics(data: BvhData, frames: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """World-space joint positions, (T, n_joints, 3).

    Vectorized over frames: local rotation matrices for all joints at once,
    then a single parent-chain pass (joints are stored parent-before-child in
    BVH, so one ordered loop over joints suffices; each step is a batched
    matmul over T frames).  Replaces pymo's per-frame
    ``MocapParameterizer('position')`` (reference pymo/preprocessing.py:14),
    which the reference uses for the BVH-level FID (data_tools.py:380-384).
    """
    frames = data.frames if frames is None else frames
    T = frames.shape[0]
    n = len(data.joints)
    pos = np.zeros((T, n, 3))
    rot = np.zeros((T, n, 3, 3))

    for idx, j in enumerate(data.joints):
        if j.is_end_site or not j.channels:
            local_rot = np.broadcast_to(np.eye(3), (T, 3, 3))
            local_pos = j.offset
        else:
            order = data.rotation_order(j)
            rot_cols = [j.channel_start + k for k, c in enumerate(j.channels)
                        if c in _AXIS_OF]
            local_rot = _euler_deg_to_matrix_np(frames[:, rot_cols], order)
            local_pos = j.offset
            trans_cols = {c: j.channel_start + k
                          for k, c in enumerate(j.channels)
                          if c.endswith("position")}
            if trans_cols:
                local_pos = j.offset + np.stack(
                    [frames[:, trans_cols.get(f"{ax}position",
                                              j.channel_start)]
                     if f"{ax}position" in trans_cols else
                     np.zeros(T) for ax in "XYZ"], axis=-1)
        if j.parent < 0:
            rot[:, idx] = local_rot
            pos[:, idx] = local_pos
        else:
            p = j.parent
            rot[:, idx] = rot[:, p] @ local_rot
            pos[:, idx] = pos[:, p] + np.einsum(
                "tij,...j->ti", rot[:, p], local_pos)
    return pos


def rewrite_template(
    template_text: str,
    euler_deg_141: np.ndarray,            # (T, 141) denormalized euler degrees
    header_lines: int = None,
    indices: np.ndarray = SPINE_NECK_141_IN_BEAT,
) -> str:
    """Write generated motion into a full-skeleton BVH template.

    Equivalent of the reference's ``result2target_vis``
    (trainers/ddpm_beat_trainer.py:1386-1427): keep the template's header,
    take its first motion frame as the rest pose (legs, hips, untracked
    fingers), scatter the 141 generated channels in, emit all frames.  One
    numpy scatter instead of a per-frame per-joint dict loop.  (The reference
    drops the first generated frame due to an off-by-one; we keep it.)
    """
    lines = template_text.splitlines()
    if header_lines is None:
        # autodetect: the motion block starts after the "Frame Time:" line
        header_lines = next(i for i, ln in enumerate(lines)
                            if ln.startswith("Frame Time")) + 1
    header = lines[:header_lines]
    rest_pose = np.fromstring(lines[header_lines], dtype=np.float64, sep=" ")
    T = euler_deg_141.shape[0]
    for i, ln in enumerate(header):
        if ln.startswith("Frames:"):
            header[i] = f"Frames: {T}"
    full = scatter_subset_into_full(euler_deg_141, rest_pose, indices)
    body = [" ".join("%.6f" % v for v in row) for row in full]
    return "\n".join(header + body) + "\n"


def rewrite_template_file(template_path: str, euler_deg_141: np.ndarray,
                          out_path: str, **kw) -> None:
    with open(template_path) as f:
        text = f.read()
    with open(out_path, "w") as f:
        f.write(rewrite_template(text, euler_deg_141, **kw))
