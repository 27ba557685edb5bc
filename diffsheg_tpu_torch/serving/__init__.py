"""Network serving: the TCP daemon around LiveSession and its client."""

from diffsheg_tpu_torch.serving.server import MotionClient, MotionServer

__all__ = ["MotionClient", "MotionServer"]
