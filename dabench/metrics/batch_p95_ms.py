"""The 95th percentile, over every call of the window, of the time from
the call's start to its outputs in host memory (the card's clock)."""

from dabench.yardstick import percentile


def read(run):
    return percentile(run.window.latency_ms, 95) if run.window.latency_ms else None
