"""Device time of the kernels other than the adder-graph kernel (the
executor's glue: requantisation, ReLU, transposes, residuals, unfold,
pools, casts) in the traced window, per sample completed in it."""

from dabench.kernels import is_adder_graph


def read(run):
    if run.trace is None or not run.traced.samples:
        return None
    glue = run.trace.op_seconds(lambda kind, name: kind == "kernel" and not is_adder_graph(name))
    return glue / run.traced.samples * 1e9
