"""The active queue's length each drain left behind (the pop_batch
spans' queue_depth), mean over the drains that started in the window."""


def read(run):
    depths = [e["args"]["queue_depth"] for e in run.host_spans
              if e["name"] == "pop_batch"
              and "queue_depth" in e.get("args", {})
              and run.t0 <= e["ts"] / 1e6 <= run.t1]
    if not depths:
        return None
    return sum(depths) / len(depths)
