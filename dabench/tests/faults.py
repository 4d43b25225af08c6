"""Faults planted on the timed path: each wraps a design's ``forward_int``
and must make a run come out not correct."""

import torch


def _stale(design):
    """A step that returns its state unchanged: the first call's outputs
    for every call."""
    first = []

    def f(x):
        if not first:
            first.append(design.forward_int(x).clone())
        return first[0]

    return f


def _half(design):
    """Half of the batch left out."""
    def f(x):
        n = x.shape[0] // 2
        y = design.forward_int(x[:n])
        return torch.cat([y, torch.zeros_like(y)])

    return f


def _altered(design):
    """One answer altered where it is produced."""
    def f(x):
        y = design.forward_int(x).clone()
        y[0, 0] += 1
        return y

    return f


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}
