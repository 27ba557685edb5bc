"""Host microseconds a kernel launch takes in the program: the mean
duration of its ``launch.*`` span records (a launch's argument checks,
plan, allocations and the call), on the host's clock alone.  Nothing to
read: None."""

from benchmark.program_spans import records


def read(view, facts):
    durations = [r.end_ns - r.start_ns for r in records() or ()
                 if r.name.startswith("launch.")]
    if not durations:
        return None
    return 1e-3 * sum(durations) / len(durations)
