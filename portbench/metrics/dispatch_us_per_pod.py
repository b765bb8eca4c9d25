"""The scheduler's device_solve stage, which times the host's
enqueue of an asynchronous launch (not the device), per pod bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    return stage_us_per_pod(run, "device_solve")
