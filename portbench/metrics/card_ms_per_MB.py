"""Milliseconds of the card's busy time (the union of its kernel, copy and
set intervals in the device trace of the window) per MB (10^6 bytes) that
the window's decompress calls returned: what a restore holds the card
for, over all the work and all the time of the window."""

from portbench import measure


def read(run):
    return measure.card_ms_per_mb(run)
