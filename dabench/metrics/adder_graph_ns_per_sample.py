"""Device time of the adder-graph kernel's launches in the traced window,
per sample completed in it: the program's ``adder_graph`` device spans
(CUDA events around each launch), split from the executor's glue."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("adder_graph",))
