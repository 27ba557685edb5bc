"""The device's idle milliseconds inside the program's ``sampler.call``
spans (each a model call: the level gather, both branches' preparation,
their launches), over their count: the host's share of a call that the
call itself holds.  Nothing to read: None."""

from benchmark.program_spans import idle_seconds, program_view


def read(view, facts):
    pv = program_view(view)
    calls = [] if pv is None else pv.spans.get("sampler.call", [])
    if not calls:
        return None
    return 1e3 * idle_seconds(pv, calls) / len(calls)
