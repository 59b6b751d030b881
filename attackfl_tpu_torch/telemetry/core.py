"""The ``Telemetry`` facade: one object bundling the event log, tracer
and counters, built from a :class:`~attackfl_tpu_torch.config.Config`
(the port's copy of ``attackfl_tpu/telemetry/core.py``).

Output routing: ``ATTACKFL_TELEMETRY_DIR`` overrides the config's
``log_path`` as the base directory; explicit ``telemetry.events_path`` /
``telemetry.trace_path`` override the defaults ``<base>/events.jsonl``
and ``<base>/trace.json``.  A process of a run over several writes
``events.<i>.jsonl`` and ``trace.<i>.json``, or the explicit paths with
``.<i>`` spliced in before the extension, under the shared ``run_id``.

With ``telemetry.enabled: false`` the facade is inert: no file is
opened, the event log and tracer are null objects, and only the
in-memory counters stay live.
"""

from __future__ import annotations

import os
from typing import Any

from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import EventLog, NullEventLog
from attackfl_tpu_torch.telemetry.trace import NullTracer, Tracer

ENV_DIR = "ATTACKFL_TELEMETRY_DIR"


class Telemetry:
    def __init__(self, events, tracer, counters: Counters, enabled: bool,
                 base_dir: str | None = None):
        self.events = events
        self.tracer = tracer
        self.counters = counters
        self.enabled = enabled
        # output base: the ledger defaults to <base_dir>/ledger
        self.base_dir = base_dir

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(NullEventLog(), NullTracer(), Counters(), False)

    @classmethod
    def from_config(cls, cfg: Any, process_index: int | None = None,
                    run_id: str | None = None) -> "Telemetry":
        """The facade of ``cfg``.  ``process_index`` (a run over several
        processes) routes the output to that process's files, so that N
        processes on one filesystem never share one; ``run_id`` is the
        id process 0 broadcast (JAX core.py:42-75)."""
        tcfg = getattr(cfg, "telemetry", None)
        if tcfg is None or not getattr(tcfg, "enabled", False):
            return cls.disabled()
        base = os.environ.get(ENV_DIR) or getattr(cfg, "log_path", ".") or "."
        suffix = "" if process_index is None else f".{process_index}"

        def routed(path: str) -> str:
            root, ext = os.path.splitext(path)
            return f"{root}{suffix}{ext}"

        events_path = routed(tcfg.events_path or os.path.join(base, "events.jsonl"))
        trace_path = routed(tcfg.trace_path or os.path.join(base, "trace.json"))
        return cls(EventLog(events_path, sample_every=tcfg.sample_every, run_id=run_id,
                            process_index=process_index),
                   Tracer(trace_path), Counters(), True, base_dir=base)

    def flush(self) -> None:
        """Persist everything buffered (the trace is memory-buffered; the
        event log is line-buffered already)."""
        self.tracer.write()
        self.events.flush()

    def close(self) -> None:
        """Flush and close the files; afterwards the facade is inert (a
        Simulator still runs after ``close``, writing nothing).  Safe to
        call twice."""
        if not self.enabled:
            return
        self.flush()
        self.events.close()
        self.events, self.tracer, self.enabled = NullEventLog(), NullTracer(), False
