"""Monotonic counter registry for run-level health accounting (the port's
copy of ``attackfl_tpu/telemetry/counters.py``).

Counts what the round loop otherwise only prints: rounds failed and
retried, NaN training rounds and clients, anomalies removed by defenses,
validation failures, checkpoint submits and fallbacks, executor
demotions.  A plain dict increment, so it stays live when file telemetry
is off and the snapshot is always available in-process
(``Simulator.telemetry.counters``)."""

from __future__ import annotations

import threading


class Counters:
    """The counts, bumped under a lock: the run service's workers share
    one registry from their own threads."""

    def __init__(self):
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            value = self._counts.get(name, 0) + int(n)
            self._counts[name] = value
        return value

    def get(self, name: str) -> int:
        return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        return dict(sorted(self._counts.items()))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counters({self._counts!r})"
