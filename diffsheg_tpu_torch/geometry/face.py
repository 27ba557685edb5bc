"""ARKit-style facial blendshape IO (BEAT ``facial52`` format).

The port's own copy of ``diffsheg_tpu/geometry/face.py`` (numpy only).

Read side mirrors the cache builder's JSON ingestion (reference
datasets/beat.py:195-209); write side mirrors the generated-face exporters
(reference trainers/ddpm_beat_trainer.py:1348-1384).  The 51-name list is the
BEAT facial channel order (ddpm_beat_trainer.py:105-117).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

# fmt: off
ARKIT_FACIAL_51: List[str] = [
    "browDownLeft", "browDownRight", "browInnerUp", "browOuterUpLeft",
    "browOuterUpRight", "cheekPuff", "cheekSquintLeft", "cheekSquintRight",
    "eyeBlinkLeft", "eyeBlinkRight", "eyeLookDownLeft", "eyeLookDownRight",
    "eyeLookInLeft", "eyeLookInRight", "eyeLookOutLeft", "eyeLookOutRight",
    "eyeLookUpLeft", "eyeLookUpRight", "eyeSquintLeft", "eyeSquintRight",
    "eyeWideLeft", "eyeWideRight", "jawForward", "jawLeft", "jawOpen",
    "jawRight", "mouthClose", "mouthDimpleLeft", "mouthDimpleRight",
    "mouthFrownLeft", "mouthFrownRight", "mouthFunnel", "mouthLeft",
    "mouthLowerDownLeft", "mouthLowerDownRight", "mouthPressLeft",
    "mouthPressRight", "mouthPucker", "mouthRight", "mouthRollLower",
    "mouthRollUpper", "mouthShrugLower", "mouthShrugUpper", "mouthSmileLeft",
    "mouthSmileRight", "mouthStretchLeft", "mouthStretchRight",
    "mouthUpperUpLeft", "mouthUpperUpRight", "noseSneerLeft", "noseSneerRight",
]
# fmt: on


def read_face_json(path: str, mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None) -> np.ndarray:
    """Load per-frame blendshape weights (T, 51); optionally z-normalize
    (reference datasets/beat.py:200-205)."""
    with open(path) as f:
        data = json.load(f)
    weights = np.asarray([fr["weights"] for fr in data["frames"]],
                         dtype=np.float64)
    if mean is not None:
        weights = (weights - mean) / std
    return weights


def face_frames_dict(weights: np.ndarray, fps: float,
                     names: Optional[List[str]] = None) -> Dict:
    """Build the exporter dict (reference ddpm_beat_trainer.py:1372-1383)."""
    names = names or ARKIT_FACIAL_51
    w2 = np.asarray(weights, dtype=np.float64).reshape(-1, np.shape(weights)[-1])
    frames = [
        {"weights": w.tolist(), "time": j / fps, "rotation": []}
        for j, w in enumerate(w2)
    ]
    return {"names": names, "frames": frames}


def write_face_json(weights: np.ndarray, out_path: str, fps: float = 15.0,
                    mean: Optional[np.ndarray] = None,
                    std: Optional[np.ndarray] = None,
                    names: Optional[List[str]] = None) -> None:
    """De-normalize (if stats given) and write the face JSON."""
    w = np.asarray(weights)
    w = w.reshape(-1, w.shape[-1])
    if mean is not None:
        w = w * std + mean
    with open(out_path, "w") as f:
        json.dump(face_frames_dict(w, fps, names), f, indent=4)
