"""Device time of the integer executor's ReLU steps in the traced window, per
sample completed in it: the program's ``executor.relu`` device spans."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("executor.relu",))
