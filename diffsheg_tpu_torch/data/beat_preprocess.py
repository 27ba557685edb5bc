"""Raw BEAT BVH preprocessing: full skeleton -> model channel subset.

The port's own copy of ``diffsheg_tpu/data/beat_preprocess.py`` (numpy,
host only), the offline tooling of the reference's preprocessing scripts
(reference datasets/bvh2anyjoints.py:239-391):

  - :func:`subselect_and_downsample` — parse an original BEAT mocap BVH
    (full 75-joint skeleton at 120 fps), pick the 141 ``spine_neck_141``
    rotation channels, decimate to the target fps: the header-less
    numeric ``bvh_rot`` rows the cache builder reads;
  - :func:`export_bvh_rot_dir` — that, for every BVH of a directory;
  - :func:`make_vis_template` — the full-skeleton template that exported
    motion is written into, its rest pose's rotations zeroed;
  - :func:`channel_stats` — per-channel mean / std over a directory of
    numeric frame files.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from diffsheg_tpu_torch.geometry.bvh import parse_bvh_file
from diffsheg_tpu_torch.geometry.joints import SPINE_NECK_141_IN_BEAT


def subselect_and_downsample(
    bvh_path: str,
    target_fps: float = 15.0,
    indices: np.ndarray = SPINE_NECK_141_IN_BEAT,
) -> Tuple[np.ndarray, float]:
    """(frames, len(indices)) euler degrees at ~target_fps, and the fps
    reached: every ``ceil(src_fps / target_fps)``-th frame is kept."""
    data = parse_bvh_file(bvh_path)
    src_fps = round(1.0 / data.frame_time)
    factor = max(1, math.ceil(src_fps / target_fps))
    frames = data.frames[::factor]
    return frames[:, indices], src_fps / factor


def export_bvh_rot_dir(
    src_dir: str,
    out_dir: str,
    target_fps: float = 15.0,
    log=print,
) -> int:
    """Convert every BVH in ``src_dir`` to numeric bvh_rot rows."""
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(src_dir, "*.bvh")))
    for i, f in enumerate(files):
        rot, fps = subselect_and_downsample(f, target_fps)
        out = os.path.join(out_dir, os.path.basename(f))
        np.savetxt(out, rot, fmt="%.6f")
        log(f"[beat-preprocess] {i + 1}/{len(files)} "
            f"{os.path.basename(f)}: {rot.shape} @ {fps:g} fps")
    return len(files)


def make_vis_template(bvh_path: str, out_path: str,
                      header_lines: Optional[int] = None) -> None:
    """Full-skeleton template BVH: the original header and one rest-pose
    motion line with every rotation zeroed (the root translation kept),
    what ``geometry/bvh.py::rewrite_template`` writes motion into."""
    with open(bvh_path) as f:
        lines = f.read().splitlines()
    if header_lines is None:
        header_lines = next(i for i, ln in enumerate(lines)
                            if ln.startswith("Frame Time")) + 1
    first = np.array(lines[header_lines].split(), dtype=np.float64)
    rest = np.zeros_like(first)
    rest[:3] = first[:3]
    for i, ln in enumerate(lines[:header_lines]):
        if ln.startswith("Frames:"):
            lines[i] = "Frames: 1"
    body = " ".join("%.6f" % v for v in rest)
    with open(out_path, "w") as f:
        f.write("\n".join(lines[:header_lines] + [body]) + "\n")


def channel_stats(frames_dir: str) -> Dict[str, np.ndarray]:
    """Per-channel mean / std over every numeric frame file of a
    directory, accumulated file by file."""
    from diffsheg_tpu_torch.data.beat import parse_numeric_frames

    s = sq = None
    n = 0
    for f in sorted(glob.glob(os.path.join(frames_dir, "*.bvh"))):
        x = parse_numeric_frames(f)
        if s is None:
            s, sq = np.zeros(x.shape[1]), np.zeros(x.shape[1])
        s += x.sum(0)
        sq += (x ** 2).sum(0)
        n += x.shape[0]
    if n == 0:
        raise ValueError(f"no frame files under {frames_dir}")
    mean = s / n
    std = np.sqrt(np.maximum(sq / n - mean ** 2, 1e-12))
    return {"mean": mean, "std": std}
