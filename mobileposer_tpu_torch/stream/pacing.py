"""Absolute-deadline rate pacing for realtime loops (the port's copy of
`mobileposer_tpu/stream/pacing.py`).

A realtime loop (the PoseServer tick; reference semantics: the 30 fps
live loop of mobileposer/live_demo.py:207-264) must hold a target rate
on a busy host where ``time.sleep`` overshoots by a few ms (OS timer
granularity, GIL contention with fetcher and ingest threads). Relative
pacing, ``sleep(period - work)`` re-anchored each iteration, adds that
overshoot to every period, so a 30 Hz loop sustains less than 30 Hz.

`Pacer` keeps deadlines on an absolute schedule: tick N is due at
``t0 + N*period``, so one sleep's overshoot eats into the next interval's
slack instead of accumulating into the period. If the loop falls more
than one period behind (a slow tick, a GC pause), it realigns to now
rather than bursting to catch up: realtime consumers want a steady rate,
not a packet flood.
"""

from __future__ import annotations

import time


class Pacer:
    """Hold a loop at ``1/period`` Hz with absolute deadlines.

    Usage::

        pacer = Pacer(1.0 / 30.0)
        while running:
            do_work()
            pacer.wait()          # sleeps until the next absolute slot

    ``clock`` / ``sleep`` are injectable for deterministic tests.
    """

    __slots__ = ("period", "_clock", "_sleep", "_next")

    def __init__(self, period: float, *, clock=time.perf_counter,
                 sleep=time.sleep):
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        self.period = period
        self._clock = clock
        self._sleep = sleep
        # first deadline is one period after construction (arm the
        # schedule when the loop starts, not lazily on first wait —
        # the first work unit already consumes slot 0)
        self._next = clock() + period

    def wait(self) -> None:
        """Sleep until the next scheduled slot, then advance it.

        If the loop is already past the deadline (work ran long), do
        not sleep and realign the schedule to now + period: missed
        slots are dropped, never bursted.
        """
        now = self._clock()
        if now < self._next:
            self._sleep(self._next - now)
            # advance on the absolute schedule — sleep overshoot does
            # NOT move the next deadline
            self._next += self.period
        else:
            self._next = now + self.period
