"""Device milliseconds a clip spends in HuBERT: the operations launched
inside the program's ``frontend.hubert`` spans (placed on the trace's
clock by ``program_spans.py``), summed, over the clips traced.  Nothing
to read: None."""

from benchmark.program_spans import program_view


def read(view, facts):
    pv = program_view(view)
    ops = [] if pv is None else pv.launched_in("frontend.hubert")
    if not ops:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / facts["items"]
