"""Milliseconds of the card's copies between host and device (device
trace, operations named Memcpy) per MB that the window's calls returned:
the part of the card's time a restore spends moving bytes."""

from portbench import measure


def read(run):
    return measure.device_ms_per_mb(run, "Memcpy")
