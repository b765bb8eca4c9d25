"""The dispatcher's waits inside the batch window, with pods in hand
(the window_wait stage, a part of pop_wait), in the window, per pod
bound."""

from portbench.readers import stage_us_per_pod


def read(run):
    if "window_wait" not in run.stages1:
        return None
    return stage_us_per_pod(run, "window_wait")
