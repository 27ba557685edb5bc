"""The share of the card's bf16 peak that the clips' work fills: the
operations a clip needs (counted from shapes in ``flops/``) times the
clips traced, over the traced window's seconds times 989 TFLOP/s."""

from benchmark.flops.model import PEAKS


def read(view, facts):
    lo, hi = view.window()
    if hi <= lo:
        return None
    ops = facts["ops_per_item"] * facts["items"]
    return 100.0 * ops / ((hi - lo) * PEAKS["bf16_flops"])
