"""Bytes of original data that the window's decompress calls returned, in
MB (10^6 bytes), over the window's seconds: from its start to the end of
its last call."""

from portbench import measure


def read(run):
    return measure.decompress_MBps(run)
