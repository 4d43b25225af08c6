"""The adder-graph kernel's share of its roofline in the traced window:
the least time the card could take for the window's matrix applications
(``yardstick.bound_s``) over the kernel's device time."""

from dabench import yardstick
from dabench.kernels import is_adder_graph


def read(run):
    if run.trace is None or run.peaks is None or not run.traced.samples:
        return None
    t = run.trace.op_seconds(lambda kind, name: kind == "kernel" and is_adder_graph(name))
    if t <= 0:
        return None
    return 100.0 * yardstick.bound_s(run.config, run.traced.samples, run.peaks) / t
