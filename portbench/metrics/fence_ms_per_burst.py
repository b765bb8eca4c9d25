"""The client's fence after each burst: from the first delete call
until the scheduler's cache holds none of the burst, mean ms."""


def read(run):
    if not run.fences:
        return None
    return sum(e - s for s, e in run.fences) / len(run.fences) * 1e3
