"""Structured profiling windows at the executors' dispatch seams (the
port's copy of ``attackfl_tpu/profiler/capture.py``).

:class:`HotspotCapture` opens one ``torch.profiler`` window over a
1-based inclusive round range (``telemetry.hotspots``, or
``profile_rounds``) and:

* **fails open** — a missing/unwritable profile directory, another
  profiler already active, another window open in the process (the run
  service's jobs are threads of one process, and a second
  ``torch.profiler`` session started beside a first ends the first's and
  crashes its stop), or a raising ``start`` degrades to a
  schema-v14 ``hotspot`` event with ``status: unavailable`` plus a
  counter; the run itself is never affected, and the window is spent so
  a broken profiler is asked exactly once, not every round;
* **closes structured** — each window that does open is stopped at the
  seam and exported with ``export_chrome_trace`` to a new
  ``<telemetry base>/profile/<host>.<pid>.<n>.<device>.trace.json.gz``
  (written as JSON, then gzipped at level 1: an ``xla`` round is a
  hundred thousand rows, and the export's own ``.gz`` path compresses at
  level 9, several times slower), mined inline
  (:mod:`attackfl_tpu_torch.profiler.mine`) and emitted as one
  ``hotspot`` event carrying the trace path, the window rounds, the
  dispatch program name (sync / fused / pipelined) and the compact
  attribution summary (top ops, category shares, host-bound fraction,
  books);
* **surfaces live** — the summary is pushed to the run monitor when one
  is attached (``/hotspots`` route + the
  ``attackfl_host_bound_fraction`` gauge).

The activities follow the run's device: CPU and CUDA activity on a CUDA
run, CPU activity only on a CPU run.  Stopping flushes the profiler's
device buffers and waits for the card, as ``jax.profiler.stop_trace``
blocks: a window's close makes a host sync, the rounds outside it none.
``torch.profiler`` is imported when a window opens, never with the
module.  Legacy ``profile`` start/stop/start_failed events keep flowing
as the JAX package writes them.
"""

from __future__ import annotations

import gzip
import itertools
import os
import shutil
import socket
import threading
import time
from typing import Any

from attackfl_tpu_torch.device import CAPTURE_LOCK
from attackfl_tpu_torch.profiler.mine import compact_summary, find_traces, mine_trace
from attackfl_tpu_torch.telemetry.console import print_with_color

# the n of <host>.<pid>.<n>.<device>.trace.json.gz, per process
_WINDOWS = itertools.count()
# held while a window is open: one torch.profiler session per process
_OPEN = threading.Lock()


def _short(error: BaseException) -> str:
    return f"{type(error).__name__}: {error}"[:300]


def _export(profiler, path: str) -> None:
    """The stopped profiler's Chrome trace at ``path`` (``.gz``)."""
    plain = path[:-len(".gz")]
    profiler.export_chrome_trace(plain)
    if not os.path.exists(plain):
        return
    try:
        with open(plain, "rb") as src, gzip.open(path, "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 22)
    finally:
        os.remove(plain)


def _profiler_active() -> bool:
    """Whether a torch profiler is already recording: a second ``start``
    would end the first's session rather than raise."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


class HotspotCapture:
    """One profiling window per run, opened/closed at dispatch seams.

    ``window`` is the parsed ``(first, last)`` inclusive round range
    (from ``telemetry.hotspots`` or, compatibly, ``profile_rounds``) or
    None for no profiling; ``device`` the run's device type (``cuda`` or
    ``cpu``).  The engine's ``_maybe_start_profile`` /
    ``_maybe_stop_profile`` delegate here 1:1.  ``timings`` keeps the
    last window's open, close and export milliseconds.
    """

    def __init__(self, telemetry: Any, window: tuple[int, int] | None,
                 monitor: Any = None, device: str = "cuda") -> None:
        self.telemetry = telemetry
        self.window = window if telemetry.enabled else None
        self.monitor = monitor
        self.device = device
        self.timings: dict[str, float] = {}
        self._profiler = None
        self._program = ""
        self._first = 0
        self._last = 0
        self._path = ""
        self._seen: frozenset[str] = frozenset()

    @property
    def profiling(self) -> bool:
        return self._profiler is not None

    # -- open ----------------------------------------------------------

    def maybe_start(self, first_round: int, last_round: int | None = None,
                    program: str = "sync") -> None:
        """Open the trace when [first_round, last_round] overlaps the
        window.  Fused chunks pass their whole round range (the chunk is
        one dispatch; profiling starts at its boundary).  ``program``
        names the dispatch seam for the window's ``hotspot`` event."""
        if self.window is None or self._profiler is not None:
            return
        start, stop = self.window
        last_round = first_round if last_round is None else last_round
        if last_round < start or first_round > stop:
            return
        path = os.path.join(self.telemetry.base_dir or ".", "profile")
        # Preflight the artifact directory BEFORE asking the profiler —
        # an unwritable disk degrades the window, never the run.
        try:
            os.makedirs(path, exist_ok=True)
            probe = os.path.join(path, ".hotspot_writable")
            with open(probe, "w"):
                pass
            os.remove(probe)
        except OSError as e:
            self._degrade(path, first_round, last_round, program,
                          f"profile dir unwritable ({_short(e)})")
            return
        self._seen = frozenset(find_traces(path))
        t0 = time.perf_counter()
        owned = False
        try:
            owned = _OPEN.acquire(blocking=False)
            if not owned:
                raise RuntimeError("another profiling window is open in this process")
            if _profiler_active():
                raise RuntimeError("another torch profiler is already active")
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            if owned:
                _OPEN.release()
            self._degrade(path, first_round, last_round, program,
                          f"start failed ({_short(e)})")
            return
        self.timings = {"open_ms": (time.perf_counter() - t0) * 1e3}
        self._profiler = profiler
        self._program = program
        self._first = first_round
        self._last = max(last_round, first_round)
        self._path = path
        self.telemetry.events.emit("profile", action="start", path=path,
                                   round=first_round)

    def _degrade(self, path: str, first: int, last: int, program: str,
                 reason: str) -> None:
        """Fail-open: one loud unavailable record + counter, window
        spent (no retry storm), run untouched."""
        self.telemetry.events.emit(
            "profile", action="start_failed", path=path, error=reason)
        self.telemetry.events.emit(
            "hotspot", status="unavailable", program=program,
            round_first=first, round_last=max(last, first), reason=reason)
        self.telemetry.counters.inc("hotspot_windows_unavailable")
        print_with_color(f"[hotspots] window unavailable: {reason}", "yellow")
        self.window = None

    # -- close ---------------------------------------------------------

    def maybe_stop(self, completed_rounds: int = 0, force: bool = False) -> None:
        """Close the trace once the window's last round completed (or on
        ``force`` at run end), export and mine it and emit one
        ``hotspot`` event."""
        if self._profiler is None:
            return
        if not force and completed_rounds < self.window[1]:
            return
        profiler, self._profiler = self._profiler, None
        out = os.path.join(self._path, f"{socket.gethostname()}.{os.getpid()}."
                                       f"{next(_WINDOWS)}.{self.device}.trace.json.gz")
        try:
            try:
                t0 = time.perf_counter()
                with CAPTURE_LOCK:
                    profiler.stop()
                t1 = time.perf_counter()
                _export(profiler, out)
                t2 = time.perf_counter()
            finally:
                _OPEN.release()
        except Exception as e:  # noqa: BLE001
            reason = f"stop failed ({_short(e)})"
            self.telemetry.events.emit("profile", action="stop_failed", error=_short(e))
            self.telemetry.events.emit(
                "hotspot", status="unavailable", program=self._program,
                round_first=self._first, round_last=self._last, reason=reason)
            self.telemetry.counters.inc("hotspot_windows_unavailable")
            return
        self.timings.update(close_ms=(t1 - t0) * 1e3, export_ms=(t2 - t1) * 1e3)
        self.telemetry.events.emit("profile", action="stop", round=completed_rounds)
        # the trace stayed open until here: the window's true coverage
        # runs to the last completed round (the sync seam starts with a
        # single round number but profiles through the window's end)
        if completed_rounds > self._last:
            self._last = int(completed_rounds)
        try:
            self._emit_window()
        except Exception as e:  # noqa: BLE001 — mining must not kill a run
            self.telemetry.events.emit(
                "hotspot", status="torn", program=self._program,
                round_first=self._first, round_last=self._last,
                reason=f"mining failed ({_short(e)})")
            self.telemetry.counters.inc("hotspot_windows_torn")

    def _emit_window(self) -> None:
        new = [p for p in find_traces(self._path) if p not in self._seen]
        if not new:
            # the profiler stopped cleanly but wrote nothing — counted,
            # not hidden
            self.telemetry.events.emit(
                "hotspot", status="empty", program=self._program,
                round_first=self._first, round_last=self._last,
                reason="no trace artifact written")
            self.telemetry.counters.inc("hotspot_windows_empty")
            return
        base = self.telemetry.base_dir or "."
        for path in new:
            report = mine_trace(path, device=self.device)
            status = report["status"]
            summary = compact_summary(report)
            self.telemetry.events.emit(
                "hotspot", status=status, program=self._program,
                round_first=self._first, round_last=self._last,
                trace=os.path.relpath(path, base), **summary)
            self.telemetry.counters.inc(f"hotspot_windows_{status}")
            if status == "ok":
                fraction = report.get("host_bound_fraction")
                top = summary["top_ops"][0]["name"] if summary["top_ops"] else "-"
                print_with_color(
                    f"[hotspots] {self._program} rounds {self._first}-{self._last}: "
                    f"top={top} hostbound={fraction} ({report.get('classification')})",
                    "cyan")
                if self.monitor is not None:
                    self.monitor.set_hotspots({
                        "program": self._program, "round_first": self._first,
                        "round_last": self._last, **summary})
