"""The program's own device spans (``repro_torch.obs.trace``) in the
traced window: the integer executor's steps and the adder-graph kernel's
launches, timed on the card by the program's CUDA events, which the
profiler's kernel names cannot tell apart (one generic aten kernel serves
the bias add, ReLU, requantisation and transpose alike).

The program records spans while the profiler records, so the spans it
holds at the reading are the traced window's.  A reader gets ``None``
where the program records no device spans (a tree without them), where
its ring dropped spans, or where the spans' forwards do not add up to
the window's samples (spans recorded outside the window as well, as
under ``REPRO_TRACE=1``).
"""

from __future__ import annotations

from collections import defaultdict


def window_spans(run) -> list | None:
    """The traced window's device spans, or ``None`` (module docstring)."""
    if run.traced is None or not run.traced.samples:
        return None
    from repro_torch.obs import trace

    read = getattr(trace, "spans", None)
    if read is None:
        return None
    items, dropped = read()
    if dropped:
        return None
    dev = [s for s in items if getattr(s, "device_start_ns", None) is not None]
    forwards = [s for s in dev if s.name == "executor.forward"]
    if not forwards or sum(s.args["batch"] for s in forwards) != run.traced.samples:
        return None
    return dev


def self_ns(span, children) -> int:
    """``span``'s device time less the part of it that its children's
    device times cover."""
    a, b = span.device_start_ns, span.device_end_ns
    covered = 0
    cur = None
    for lo, hi in sorted((max(c.device_start_ns, a), min(c.device_end_ns, b)) for c in children):
        if hi <= lo:
            continue
        if cur is None or lo > cur[1]:
            if cur is not None:
                covered += cur[1] - cur[0]
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    if cur is not None:
        covered += cur[1] - cur[0]
    return b - a - covered


def ns_per_sample(spans, samples: int, names, self_time: bool = False) -> float:
    """Device time of the spans named in ``names`` (their self time with
    ``self_time``) per sample."""
    if self_time:
        children = defaultdict(list)
        for s in spans:
            children[s.parent].append(s)
        total = sum(self_ns(s, children[s.id]) for s in spans if s.name in names)
    else:
        total = sum(s.device_end_ns - s.device_start_ns for s in spans if s.name in names)
    return total / samples


def read_ns_per_sample(run, names, self_time: bool = False) -> float | None:
    """:func:`ns_per_sample` over the traced window's samples, or ``None``."""
    spans = window_spans(run)
    if spans is None:
        return None
    return ns_per_sample(spans, run.traced.samples, names, self_time)
