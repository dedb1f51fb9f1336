"""PLANTED VIOLATIONS — wallclock_duration.

Every subtraction of ``time.time()`` readings below is a duration from
the wall clock, which steps and slews under NTP. Durations use
``time.monotonic()`` / ``time.perf_counter()``.
"""

import time


def direct_subtraction():
    t0 = time.time()
    do_work = sum(range(10))
    elapsed = time.time() - t0  # bad: wallclock duration
    return do_work, elapsed


def both_sides_named():
    start = time.time()
    end = time.time()
    return end - start  # bad: both operands are wallclock readings


class Poller:
    def __init__(self):
        self._anchor = time.time()

    def stale_for(self):
        self._anchor = time.time()
        return time.time() - self._anchor  # bad: an age from the wall clock


def timestamp_only_is_fine():
    # near miss: a timestamp, never subtracted
    return {"wall_time": round(time.time(), 3)}


def monotonic_is_fine():
    t0 = time.monotonic()
    return time.monotonic() - t0  # near miss: the right clock
