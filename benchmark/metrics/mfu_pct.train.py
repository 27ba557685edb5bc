"""The share of the card's TF32 peak that the training steps' work fills:
forward and backward (three times the forward's operations, counted
from shapes in ``flops/``; remat's recompute not counted) times the steps
traced, over the traced window's seconds times 495 TFLOP/s, the most an
f32 product reaches on the card."""

from benchmark.flops.model import PEAKS


def read(view, facts):
    lo, hi = view.window()
    if hi <= lo:
        return None
    ops = facts["ops_per_item"] * facts["items"]
    return 100.0 * ops / ((hi - lo) * PEAKS["tf32_flops"])
