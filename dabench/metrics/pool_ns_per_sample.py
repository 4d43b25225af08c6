"""Device time of the integer executor's max and average pools in the
traced window, per sample completed in it: the program's ``executor.pool``
device spans."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("executor.pool",))
