"""The whole step's share of the card's int8 dense peak: 2 x the
network's multiply-accumulates per sample x the window's samples per
second."""

from dabench import yardstick


def read(run):
    if run.peaks is None:
        return None
    rate = run.window.samples / run.window.seconds
    return 100.0 * 2 * yardstick.macs_per_sample(run.config) * rate / run.peaks["int8_ops_per_s"]
