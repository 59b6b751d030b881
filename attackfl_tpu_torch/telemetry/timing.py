"""Wall-clock phase timing (the port's copy of
``attackfl_tpu/telemetry/timing.py``).

``RoundTimer`` times a round's phases into its ``durations`` dict and
mirrors each phase into a :class:`~attackfl_tpu_torch.telemetry.trace.Tracer`
span, so one call site feeds both the round's ``phases`` and the Chrome
trace.  The host clock measures what the host waits for: a phase that
ends without a read of the card measures its dispatch only.  Time the
tracer discounts inside a phase (the cost model's bookkeeping during a
counted dispatch) is not the phase's.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class RoundTimer:
    """Wall-clock timing of round phases."""

    def __init__(self, tracer=None):
        self.durations: dict[str, float] = {}
        self._tracer = tracer

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        discounted0 = getattr(self._tracer, "discounted_us", 0.0)
        try:
            if self._tracer is None:
                yield
            else:
                with self._tracer.span(name):
                    yield
        finally:
            discounted = (getattr(self._tracer, "discounted_us", 0.0) - discounted0) / 1e6
            self.durations[name] = (
                self.durations.get(name, 0.0) + time.perf_counter() - t0 - discounted)

    def summary(self) -> str:
        return ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.durations.items())
