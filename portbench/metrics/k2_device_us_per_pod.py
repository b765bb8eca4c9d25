"""K2's time on the card, from the program's own event pair around each
launch (the device track's spans of kernel K2), clipped to the window,
per pod bound."""


def read(run):
    spans = [e for e in run.host_spans
             if e.get("args", {}).get("kernel") == "K2"]
    pods = run.bound_in_window()
    if not spans or not pods:
        return None
    seconds = sum(
        max(0.0, min((e["ts"] + e["dur"]) / 1e6, run.t1)
            - max(e["ts"] / 1e6, run.t0))
        for e in spans)
    return seconds / pods * 1e6
