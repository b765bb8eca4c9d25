"""The collector's pauses on any thread (the gc spans) clipped to the
window, per pod bound."""

from portbench.readers import clipped_span_seconds


def read(run):
    pods = run.bound_in_window()
    if not pods or not any(e["name"] == "gc" for e in run.host_spans):
        return None
    return clipped_span_seconds(
        run.host_spans, "gc", [(run.t0, run.t1)]) / pods * 1e6
