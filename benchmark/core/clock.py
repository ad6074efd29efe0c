"""The process's age, for ``setup_s``: from the moment the kernel started
this process, so that the interpreter's start and every import count."""

import os
import sys
import time


def process_age_s() -> float:
    """Seconds since this process started (clock-tick resolution), read
    from /proc on the boot-time clock; without /proc, since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat(5), after pid and comm
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError, AttributeError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def log(message: str) -> None:
    """A progress line on standard error, stamped with the process's age."""
    print(f"[{process_age_s():9.3f} s] {message}", file=sys.stderr, flush=True)
