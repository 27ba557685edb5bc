"""The speech encoder's share of the card's TF32 peak in training: its
operations a step (``flops/speech_encoder.py``: the conv extractor, the
positional conv, the products, attention, the gate and the bias) times the
steps traced, over the device seconds of the operations launched inside
the program's ``train.frontend.encoder`` spans times 495 TFLOP/s, the peak
``mfu_pct.train`` divides by.  Nothing to read: None."""

from benchmark.flops.model import PEAKS
from benchmark.train_spans import device_seconds_in


def read(view, facts):
    ops = facts.get("encoder_ops_per_step")
    s = device_seconds_in(view, "train.frontend.encoder")
    if not ops or s is None:
        return None
    return 100.0 * ops * facts["items"] / (s * PEAKS["tf32_flops"])
