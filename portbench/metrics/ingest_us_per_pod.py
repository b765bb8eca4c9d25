"""The informer thread's work on Pod watch frames (the ingest spans:
apply, handlers, the queue's add) clipped to the window, per pod
bound."""

from portbench.readers import clipped_span_seconds


def read(run):
    spans = [e for e in run.host_spans if e["name"] == "ingest"
             and e.get("args", {}).get("kind") == "Pod"]
    pods = run.bound_in_window()
    if not spans or not pods:
        return None
    return clipped_span_seconds(
        spans, "ingest", [(run.t0, run.t1)]) / pods * 1e6
