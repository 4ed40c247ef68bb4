"""lgm_tpu's native decode as the reference of the port's image tests.

``lgm_tpu/native.py`` builds ``native/libdataload.so`` with ``g++`` at its
first use, into one path for every process. Under several test workers
each worker's first call may find the library half written by another's
build; ``ctypes`` then raises, and the module remembers the failure for
the process's life. ``native_available`` forgets it and tries again until
the library loads; ``require_native`` asserts that it does: the decode is
the reference, so a missing one is a failure, not a skip."""

import time

from lgm_tpu import native


def native_available(tries: int = 120, wait_s: float = 0.5) -> bool:
    """Whether lgm_tpu's native decode loads, trying for up to
    ``tries * wait_s`` seconds while another process may be building it."""
    for _ in range(tries):
        if native.dataload_available():
            return True
        native._dl_failed = False
        time.sleep(wait_s)
    return False


def require_native() -> None:
    assert native_available(), (
        "lgm_tpu's native decode (native/dataload.cpp) does not build or "
        "load; it is the reference of these tests")
