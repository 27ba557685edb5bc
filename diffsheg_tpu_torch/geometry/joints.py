"""Skeleton joint tables for the BEAT BVH layout.

The port's own copy of ``diffsheg_tpu/geometry/joints.py`` (numpy only).

Reproduces the channel bookkeeping of the reference's ``joints_list``
(reference datasets/data_tools.py:15-359): the full 75-joint BEAT skeleton
with cumulative channel offsets, and the 47-joint upper-body subset
(``spine_neck_141`` — 47 x 3 = 141 rotation channels) that the model
generates.

The tables are built programmatically from name lists so downstream code gets
numpy index arrays (for vectorized scatter/gather into full-skeleton frames)
instead of the reference's per-frame Python dict walks
(trainers/ddpm_beat_trainer.py:1415-1424).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


# Full BEAT skeleton in BVH channel order.  Hips has 6 channels
# (translation + rotation); every other joint has 3 rotation channels.
BEAT_JOINT_ORDER: Tuple[str, ...] = tuple(
    ["Hips", "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Neck1", "Head",
     "HeadEnd"]
    + ["RShoulder", "RArm", "RArm1", "RHand",
       "RHandM1", "RHandM2", "RHandM3", "RHandM4",
       "RHandR", "RHandR1", "RHandR2", "RHandR3", "RHandR4",
       "RHandP", "RHandP1", "RHandP2", "RHandP3", "RHandP4",
       "RHandI", "RHandI1", "RHandI2", "RHandI3", "RHandI4",
       "RHandT1", "RHandT2", "RHandT3", "RHandT4"]
    + ["LShoulder", "LArm", "LArm1", "LHand",
       "LHandM1", "LHandM2", "LHandM3", "LHandM4",
       "LHandR", "LHandR1", "LHandR2", "LHandR3", "LHandR4",
       "LHandP", "LHandP1", "LHandP2", "LHandP3", "LHandP4",
       "LHandI", "LHandI1", "LHandI2", "LHandI3", "LHandI4",
       "LHandT1", "LHandT2", "LHandT3", "LHandT4"]
    + ["RUpLeg", "RLeg", "RFoot", "RFootF", "RToeBase", "RToeBaseEnd"]
    + ["LUpLeg", "LLeg", "LFoot", "LFootF", "LToeBase", "LToeBaseEnd"]
)

# 47-joint generated subset, 141 channels (reference data_tools.py:309-359).
SPINE_NECK_141_ORDER: Tuple[str, ...] = tuple(
    ["Spine", "Neck", "Neck1"]
    + [f"{h}{j}" for h in ("R", "L") for j in
       ["Shoulder", "Arm", "Arm1", "Hand",
        "HandM1", "HandM2", "HandM3",
        "HandR", "HandR1", "HandR2", "HandR3",
        "HandP", "HandP1", "HandP2", "HandP3",
        "HandI", "HandI1", "HandI2", "HandI3",
        "HandT1", "HandT2", "HandT3"]]
)


def channel_table(order: Tuple[str, ...], root_channels: int = 6) -> Dict[str, Tuple[int, int]]:
    """name -> (n_channels, end_offset) with the reference's cumulative-end
    convention (data_tools.py:220: 'Hips': [6, 6] means channels [0, 6))."""
    table: Dict[str, Tuple[int, int]] = {}
    end = 0
    for i, name in enumerate(order):
        n = root_channels if i == 0 else 3
        end += n
        table[name] = (n, end)
    return table


BEAT_CHANNELS = channel_table(BEAT_JOINT_ORDER)          # 228 channels total
BEAT_TOTAL_CHANNELS = 6 + 3 * (len(BEAT_JOINT_ORDER) - 1)

N_SPINE_NECK_JOINTS = len(SPINE_NECK_141_ORDER)          # 47
SPINE_NECK_DIM = 3 * N_SPINE_NECK_JOINTS                 # 141


def subset_channel_indices(
    subset: Tuple[str, ...] = SPINE_NECK_141_ORDER,
    full: Dict[str, Tuple[int, int]] = None,
) -> np.ndarray:
    """Flat channel indices of ``subset`` joints inside the full-skeleton
    frame vector — one gather/scatter map replacing the reference's per-joint
    slice loop (ddpm_beat_trainer.py:1420-1423).  Shape (len(subset)*3,)."""
    full = full or BEAT_CHANNELS
    idx: List[int] = []
    for name in subset:
        n, end = full[name]
        idx.extend(range(end - 3, end))  # rotation channels are the last 3
        assert n == 3 or name == "Hips"
    return np.asarray(idx, dtype=np.int64)


SPINE_NECK_141_IN_BEAT = subset_channel_indices()


def scatter_subset_into_full(
    subset_frames: np.ndarray,        # (T, 141) euler degrees
    rest_pose: np.ndarray,            # (228,) full-skeleton frame (offsets)
    indices: np.ndarray = None,
) -> np.ndarray:
    """Rebuild (T, 228) full-skeleton frames: rest pose everywhere, generated
    rotations scattered into the subset channels.  Vectorized equivalent of
    the reference's template rewrite loop (ddpm_beat_trainer.py:1415-1424)."""
    indices = SPINE_NECK_141_IN_BEAT if indices is None else indices
    T = subset_frames.shape[0]
    out = np.tile(np.asarray(rest_pose, dtype=np.float64), (T, 1))
    out[:, indices] = subset_frames
    return out
