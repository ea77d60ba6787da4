"""kanzi_tpu's native library for the port's tests, built once across test
processes.

kanzi_tpu builds its C++ library with `make` at first use and takes no lock
between processes. Under pytest-xdist several workers can then run the
build at once, and one of them can load the library while another is still
linking it ("file too short"), which fails whatever test came first in that
worker. Importing this module builds and loads the library under an
exclusive file lock. The port's test modules import it, so every worker
does so while it collects, before any worker runs a test.
"""

import fcntl
import os

from kanzi_tpu import native as jax_native


def _load_locked() -> None:
    build = os.path.join(os.path.dirname(os.path.abspath(jax_native.__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".test_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jax_native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_load_locked()
