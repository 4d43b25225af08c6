"""The host time of ``load_design``: the artifact read and its tables
rebuilt on the card."""


def read(run):
    return run.load_s
