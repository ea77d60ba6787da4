"""Kernel launches of the window (the program's launch counter) per MiB
that the window's calls returned."""

from portbench import measure


def read(run):
    return measure.launches_per_mib(run)
