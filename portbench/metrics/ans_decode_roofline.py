"""K6's share of its roofline, in %: the least time of the ANS order-1
decode work of the window's calls over the device time of K6's call (its
table pass and its decode kernel) in the trace."""

from portbench import peaks


def read(run):
    return peaks.roofline_percent(
        run, 8, ("ans_decode_kernel", "ans_table_kernel", "ans_wide_kernel"))
