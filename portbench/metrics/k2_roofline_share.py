"""K2's least time over its device time, summed over the launches of
the traced window."""

from portbench.readers import roofline_share


def read(run):
    if run.device is None:
        return None
    return roofline_share(run.k2_records,
                          run.device.launches("constrained_cluster_kernel",
                                              after=run.capture_t0))
