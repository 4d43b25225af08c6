"""Kernels the card ran in the traced window per call completed in it
(a replayed graph's kernels counted one by one)."""


def read(run):
    if run.trace is None or not run.traced.completed:
        return None
    return run.trace.count(lambda kind, name: kind == "kernel") / run.traced.completed
