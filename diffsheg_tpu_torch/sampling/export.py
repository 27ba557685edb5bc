"""Motion export: normalized model output -> npy / BVH / face JSON.

Counterpart of ``diffsheg_tpu/sampling/export.py``.  The reference writes,
per generated clip, the denormalized npy, a euler-degree BVH via
``result2target_vis`` and the face-blendshape JSON (reference
trainers/ddpm_beat_trainer.py:1044-1089, :1322-1341).  The axis-angle ->
euler conversion runs in torch, float32, on the exporter's device (the
card unless the caller asks for the CPU); de-normalization, the BVH
template rewrite and the JSON are host-side numpy and IO, as in JAX.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.device import DeviceLike, resolve_device


class BeatMotionExporter:
    """Owns the normalization stats, the vis template and the device of
    the euler conversion."""

    def __init__(self, pose_dim: int, fps: float,
                 motion_mean: np.ndarray, motion_std: np.ndarray,
                 template_bvh: Optional[str] = None,
                 player: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.pose_dim = pose_dim
        self.fps = fps
        # --remove_hand models emit the 33-channel hand-free subset while
        # dataset stats cover the full 141+51 layout: select the matching
        # channels (data/beat.py BEAT_HAND_FREE_CHANNELS)
        if (motion_mean is not None and pose_dim != 141
                and motion_mean.shape[-1] == 192):
            from diffsheg_tpu_torch.data.beat import BEAT_HAND_FREE_CHANNELS
            assert pose_dim == len(BEAT_HAND_FREE_CHANNELS), pose_dim
            sel = np.r_[BEAT_HAND_FREE_CHANNELS, np.arange(141, 192)]
            motion_mean = np.asarray(motion_mean)[sel]
            motion_std = np.asarray(motion_std)[sel]
        self.motion_mean = motion_mean
        self.motion_std = motion_std
        self.template_bvh = template_bvh
        self.player = player

    def euler_degrees(self, pose_aa: np.ndarray) -> np.ndarray:
        """(T, pose_dim) axis-angle -> (T, pose_dim) XYZ euler degrees:
        converted in float32 on the exporter's device, ``rad2deg`` on the
        host."""
        from diffsheg_tpu_torch.geometry.rotations import axis_angle_to_euler
        T = pose_aa.shape[0]
        aa = torch.as_tensor(
            np.asarray(pose_aa).reshape(T, self.pose_dim // 3, 3),
            dtype=torch.float32).to(self.device)
        eul = axis_angle_to_euler(aa, "XYZ").cpu().numpy()
        return np.rad2deg(eul).reshape(T, self.pose_dim)

    def export(self, motion: np.ndarray, out_dir: str, name: str
               ) -> List[str]:
        """(T, motion_dim) normalized output -> files; returns paths."""
        from diffsheg_tpu_torch.geometry.face import write_face_json

        os.makedirs(out_dir, exist_ok=True)
        pose_dim = self.pose_dim
        denorm = motion * self.motion_std + self.motion_mean
        pose_aa, facial = denorm[:, :pose_dim], denorm[:, pose_dim:]
        written: List[str] = []

        npy_path = os.path.join(out_dir, f"{name}.npy")
        np.save(npy_path, denorm)
        written.append(npy_path)

        # BVH rewrite assumes the full SPINE_NECK 141-channel layout
        # (data_tools.py:548-607); subset models export npy + face only
        bvh_path = None
        if self.template_bvh and os.path.exists(self.template_bvh) \
                and pose_dim == 141:
            from diffsheg_tpu_torch.geometry.bvh import rewrite_template_file
            bvh_path = os.path.join(out_dir, f"{name}.bvh")
            rewrite_template_file(self.template_bvh,
                                  self.euler_degrees(pose_aa), bvh_path)
            written.append(bvh_path)

        face_path = None
        if facial.shape[-1]:
            face_path = os.path.join(out_dir, f"{name}_face.json")
            write_face_json(facial, face_path, fps=self.fps)
            written.append(face_path)

        # optional HTML player baked from the just-written BVH (+face)
        if self.player:
            if bvh_path is None:
                import warnings
                warnings.warn(
                    "player requested but no BVH was written (needs an "
                    "existing template_bvh and the full 141-channel pose); "
                    "skipping the HTML player")
            else:
                from diffsheg_tpu_torch.viz.player import export_bvh_player
                html = os.path.join(out_dir, f"{name}_player.html")
                written.append(export_bvh_player(bvh_path, html,
                                                 face_json=face_path))
        return written
