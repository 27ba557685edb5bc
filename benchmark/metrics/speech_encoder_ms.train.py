"""Device milliseconds a training step spends in the speech encoder: the
operations launched inside the program's ``train.frontend.encoder`` spans
(placed on the trace's clock by ``train_spans.py``), the union of their
intervals, over the steps traced.  Nothing to read: None."""

from benchmark.train_spans import device_seconds_in


def read(view, facts):
    s = device_seconds_in(view, "train.frontend.encoder")
    return None if s is None else 1e3 * s / facts["items"]
