"""The native block inverse (LZ inverse and checksum's transform half), ms
per MiB returned: BEFORE_TRANSFORM to AFTER_TRANSFORM of every block,
summed over blocks (thread time, not wall)."""

from portbench import measure


def read(run):
    return measure.transform_ms_per_mib(run)
