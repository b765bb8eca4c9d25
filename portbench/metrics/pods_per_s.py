"""Measured pods bound inside the window, over its seconds."""


def read(run):
    return run.bound_in_window() / run.seconds
