"""K8's share of its roofline, in %: the least time of the range decode
work of the window's calls over K8's device time in the trace."""

from portbench import peaks


def read(run):
    return peaks.roofline_percent(run, 4, ("range_decode_kernel",))
