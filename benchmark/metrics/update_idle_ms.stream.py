"""The device's idle milliseconds inside the program's ``sampler.update``
spans (a step's work outside the model call: noise draws, step math,
projection, tails; each undo step), over the ``sampler.call`` count.
Nothing to read: None."""

from benchmark.program_spans import idle_seconds, program_view


def read(view, facts):
    pv = program_view(view)
    if pv is None:
        return None
    calls = pv.spans.get("sampler.call", [])
    updates = pv.spans.get("sampler.update", [])
    if not calls or not updates:
        return None
    return 1e3 * idle_seconds(pv, updates) / len(calls)
