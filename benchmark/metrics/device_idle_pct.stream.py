"""The share of the traced window in which no operation ran on the
card."""


def read(view, facts):
    lo, hi = view.window()
    if hi <= lo:
        return None
    return 100.0 * (1.0 - view.busy(lo, hi) / (hi - lo))
