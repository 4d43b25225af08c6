"""Share of the traced window in which no kernel or copy ran on the card.

The profiler's own host cost counts in it: where the host paces the
loop (a graph replayed per small batch) the traced window runs slower
than the measured one and this share reads high (the result line's
``traced_samples_per_s`` against ``window_samples_per_s`` says by how
much)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
