"""The Reader's entropy stage, ms per MiB returned: from each batch's first
BEFORE_ENTROPY to its last AFTER_ENTROPY, summed over the window's calls."""

from portbench import measure


def read(run):
    return measure.entropy_ms_per_mib(run)
