"""The dispatcher's wait for arrivals (the flight recorder's pop_wait
spans) inside the bursts, from each burst's first create to its last
bind, fences excluded, per pod of those bursts."""

from portbench.readers import clipped_span_seconds


def read(run):
    done = [b for b in run.bursts if b.t_bound is not None]
    pods = sum(len(b.names) for b in done)
    if not pods or not run.host_spans:
        return None
    spans = clipped_span_seconds(
        run.host_spans, "pop_wait", [(b.t_start, b.t_bound) for b in done])
    return spans / pods * 1e6
