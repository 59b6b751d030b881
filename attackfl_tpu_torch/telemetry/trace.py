"""Nested wall-clock spans exportable as Chrome trace events (the port's
copy of ``attackfl_tpu/telemetry/trace.py``).

``Tracer.span`` wraps host-side phases (train, aggregate, validate,
checkpoint, whole chunks, a pipelined round's dispatch and resolve) and
serializes them as complete ("X") events in the Chrome trace-event JSON
format, in microseconds: load ``trace.json`` at https://ui.perfetto.dev to
see the round timeline.  It traces the host's federation loop, not the
card's kernels (``profile_round`` and ``torch.profiler`` do that).
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

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any):
        t0 = self._now_us()
        try:
            yield
        finally:
            event: dict[str, Any] = {
                "name": name, "ph": "X", "ts": round(t0, 1),
                "dur": round(self._now_us() - t0, 1),
                "pid": self._pid, "tid": 0,
            }
            if args:
                event["args"] = {k: _plain(v) for k, v in args.items()}
            self._events.append(event)

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

    @contextmanager
    def span(self, name: str, **args: Any):
        yield

    def write(self) -> None:
        pass
