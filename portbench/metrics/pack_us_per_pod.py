"""The scheduler's pack stage (host) in the window, per pod bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    return stage_us_per_pod(run, "pack")
