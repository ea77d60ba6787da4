"""The device's idle share of the traced decode window: 1 - the union of
its kernel, copy and set intervals over the window's wall time."""

from portbench import measure


def read(run):
    return measure.idle_share(run)
