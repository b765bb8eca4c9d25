"""The download stage (the committer's wait for the result: the
device's run and the copy back) in the window, per pod bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    return stage_us_per_pod(run, "download")
