"""Bytes that the traced window's decompress calls returned, in MB (10^6
bytes), over the window's seconds: the rate of decompress_MBps, read in a
traced run for a cell where that rate is too unsteady to bound. None in a
run without a trace."""

from portbench import measure


def read(run):
    if run.trace is None:
        return None
    return measure.decompress_MBps(run)
