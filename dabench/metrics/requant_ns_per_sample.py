"""Device time of the integer executor's requantisation steps (a shift
onto the target grid, then saturation) in the traced window, per sample
completed in it: the program's ``executor.requant`` device spans."""

from dabench.spans import read_ns_per_sample


def read(run):
    return read_ns_per_sample(run, ("executor.requant",))
