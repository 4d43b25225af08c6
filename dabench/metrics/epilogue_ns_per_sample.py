"""Device time of the integer executor's CMVM epilogues in the traced
window, per sample completed in it: the self time of the program's
``executor.dense`` and ``executor.conv`` device spans (bias, shift,
reshape, a convolution's unfold: all but the adder-graph launch inside
them) and of ``executor.residual`` (the merge of the two branches: all
but the body's steps)."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("executor.dense", "executor.conv", "executor.residual"),
                              self_time=True)
