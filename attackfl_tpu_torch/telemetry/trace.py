"""Nested wall-clock spans exportable as Chrome trace events (the port's
copy of ``attackfl_tpu/telemetry/trace.py``).

``Tracer.span`` wraps host-side phases (train, aggregate, validate,
checkpoint, whole chunks, a pipelined round's dispatch and resolve) and
serializes them as complete ("X") events in the Chrome trace-event JSON
format, in microseconds: load ``trace.json`` at https://ui.perfetto.dev to
see the round timeline.  It traces the host's federation loop, not the
card's kernels (``profile_round`` and ``torch.profiler`` do that).

``Tracer.discount`` takes host time that was not the program's out of
every open span: the cost model's bookkeeping during a counted dispatch
(``costmodel/capture.py``) is recorded as a ``costmodel`` span of its own
and is in no round's ``train``, ``chunk`` or ``dispatch`` span, so the
ledger's device time (``ledger/record.py``) does not count it.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any


class Tracer:
    """Collects spans in memory; ``write()`` serializes the Chrome trace
    JSON atomically (tmp + rename) so a crash mid-write can't corrupt a
    previously good trace."""

    enabled = True

    def __init__(self, path: str):
        self.path = path
        self._events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        # the open spans, outermost first: [name, args, start_us]
        self._open: list[list] = []
        # microseconds discount() took out of the open spans so far
        self.discounted_us = 0.0

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, name: str, args: dict[str, Any], t0: float, t1: float) -> None:
        event: dict[str, Any] = {
            "name": name, "ph": "X", "ts": round(t0, 1), "dur": round(t1 - t0, 1),
            "pid": self._pid, "tid": 0,
        }
        if args:
            event["args"] = {k: _plain(v) for k, v in args.items()}
        self._events.append(event)

    @contextmanager
    def span(self, name: str, **args: Any):
        frame = [name, args, self._now_us()]
        self._open.append(frame)
        try:
            yield
        finally:
            self._open.remove(frame)
            self._emit(name, args, frame[2], self._now_us())

    def discount(self, name: str, seconds: float, **args: Any) -> None:
        """Record ``seconds`` of host time just spent on something other
        than the open spans' work as a span ``name`` ending now, and take
        it out of every open span (each one's start moves later by it)."""
        now = self._now_us()
        us = seconds * 1e6
        self._emit(name, args, now - us, now)
        for frame in self._open:
            frame[2] += us
        self.discounted_us += us

    def write(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = {"traceEvents": self._events, "displayTimeUnit": "ms"}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)


def _plain(value: Any) -> Any:
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if getattr(value, "is_cuda", False):
        raise TypeError("a CUDA tensor reached a trace span: pass a host value")
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "ndim", None) in (0, None):
        try:
            return item()
        except Exception:  # noqa: BLE001
            pass
    return str(value)


class NullTracer:
    """Disabled-telemetry stand-in: span() costs one generator frame."""

    enabled = False
    path = None
    discounted_us = 0.0

    @contextmanager
    def span(self, name: str, **args: Any):
        yield

    def discount(self, name: str, seconds: float, **args: Any) -> None:
        pass

    def write(self) -> None:
        pass
