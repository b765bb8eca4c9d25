"""The commit stage (native gather, cache assume, bulk bind) in the
window, per pod bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    return stage_us_per_pod(run, "commit")
