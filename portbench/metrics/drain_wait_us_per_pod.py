"""The dispatcher's wait inside the pack stage for the batches in
flight to land (the drain_wait stage) in the window, per pod bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    if "drain_wait" not in run.stages1:
        return None
    return stage_us_per_pod(run, "drain_wait")
