"""The device's idle milliseconds inside the span around
``generate_fused`` (the window loop and sampler), over its model calls
(``fused_branch.launches`` / 2): the host's share of a call."""


def read(view, facts):
    spans = view.spans.get("sampler", [])
    if not spans or not facts["model_calls"]:
        return None
    idle = sum((b - a) - view.busy(a, b) for a, b in spans)
    return 1e3 * idle / facts["model_calls"]
