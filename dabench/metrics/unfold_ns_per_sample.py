"""Device time of the integer executor's convolution unfolds in the traced
window, per sample completed in it: the self time of the program's
``executor.conv`` device spans (the SAME zeros added and the im2col copy;
all but the adder-graph launch inside them)."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("executor.conv",), self_time=True)
