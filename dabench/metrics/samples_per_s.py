"""Samples whose outputs reached the host in the window, over its length."""


def read(run):
    return run.window.samples / run.window.seconds
