"""The traced window less the union of the device's kernels, copies
and sets, over the window, in percent."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
