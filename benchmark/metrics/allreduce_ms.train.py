"""Device milliseconds a data-parallel training step of rank 0 spends in
its cross-process means: the operations launched inside the program's
``train.allreduce`` spans (the flat gradient all-reduce and the loss
terms'; placed on the trace's clock by ``train_spans.py``), over the
steps traced.  A collective's kernel runs from its launch until every
process has joined, so the time holds the other cards' lateness too.
Nothing to read (one process, or no spans): None."""

from benchmark.train_spans import device_seconds_in


def read(view, facts):
    s = device_seconds_in(view, "train.allreduce")
    return None if s is None else 1e3 * s / facts["items"]
