"""Live run monitor: health endpoint and stall watchdog (the port's copy
of ``attackfl_tpu/telemetry/monitor.py``).

:class:`RunMonitor` runs a stdlib ``http.server`` thread (config-gated,
``telemetry.monitor``) serving

* ``/healthz`` -- 200 while rounds keep completing, 503 once the watchdog
  declares a stall (JSON body with the evidence either way), 200 with
  ``status: degraded`` while the pipelined executor is demoted;
* ``/metrics`` -- Prometheus text format: the Counters registry, rounds
  completed, the last round's phase durations, the rolling-median round
  time, the current stall threshold, the pipeline's depth gauge and the
  latest numerics gauges;
* ``/last-round`` -- the most recent round record as JSON (what
  ``python -m attackfl_tpu_torch watch`` polls);
* ``/runs`` -- the cross-run ledger's index, newest first;
* ``/programs`` -- the cost model's program profiles and a live
  roofline estimate over the rolling-median round cadence;
* ``/hotspots`` -- the latest mined profiling window per dispatch seam,
  with the ``attackfl_host_bound_fraction`` gauge in ``/metrics``.

The **stall watchdog** is a daemon thread that flags the run when no round
completes within ``stall_factor x`` the rolling-median round duration
(floored at ``MIN_STALL_SECONDS``; before the FIRST round completes the
threshold is ``stall_grace_seconds``).  On the healthy->stalled transition
it emits one ``stall`` event into the run's event log (``EventLog.emit``
is lock-serialised for this cross-thread write) and bumps the
``stalls_detected`` counter; the next completed round clears the state.
The thread reads host values only, never a tensor.

Everything here is observational: the monitor never touches simulation
state, and with ``telemetry.enabled: false`` it is never constructed.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

# Absolute floor for the stall threshold: with sub-second rounds a single
# GC pause or checkpoint fsync must not trip the watchdog.
MIN_STALL_SECONDS = 5.0


def _sanitize(name: str) -> str:
    """Counter name -> Prometheus metric-name charset."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


class JsonHTTPServer:
    """Threaded stdlib HTTP server with a route table (the JAX package's
    run service extends the same layer; the port has the monitor only).

    Routes are ``(method, path) -> handler``; a handler receives the
    parsed query dict and the raw request body (POSTs) and returns either
    ``(code, payload_dict)`` — encoded as JSON — or ``(code, bytes,
    content_type)`` for pre-encoded bodies (``/metrics`` text).  Binding
    honors ``port 0`` as "ephemeral, report the real port"; a busy FIXED
    port also falls back to ephemeral — an observability/control thread
    must never kill the run it serves — with the actual port exposed via
    :attr:`port`.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 name: str = "attackfl-http"):
        self._host = host
        self._requested_port = int(port)
        self._name = name
        self._routes: dict[tuple[str, str], Callable] = {}
        self._server: ThreadingHTTPServer | None = None
        self.port: int | None = None

    def route(self, method: str, path: str, handler: Callable) -> None:
        self._routes[(method.upper(), path)] = handler

    def start(self) -> "JsonHTTPServer":
        if self._server is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr spam
                pass

            def do_GET(self):
                outer._handle(self, "GET")

            def do_POST(self):
                outer._handle(self, "POST")

        try:
            self._server = ThreadingHTTPServer(
                (self._host, self._requested_port), Handler)
        except OSError:
            self._server = ThreadingHTTPServer((self._host, 0), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         name=self._name, daemon=True).start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @staticmethod
    def _query(request: BaseHTTPRequestHandler) -> dict[str, str]:
        _, _, raw = request.path.partition("?")
        query: dict[str, str] = {}
        for pair in raw.split("&"):
            if not pair:
                continue
            key, _, value = pair.partition("=")
            query[key] = value
        return query

    def _handle(self, request: BaseHTTPRequestHandler, method: str) -> None:
        path = request.path.split("?", 1)[0].rstrip("/") or "/"
        handler = self._routes.get((method, path))
        if handler is None:
            code, body, ctype = 404, b'{"error": "unknown path"}', \
                "application/json"
        else:
            length = int(request.headers.get("Content-Length") or 0)
            payload = request.rfile.read(length) if length else b""
            try:
                result = handler(self._query(request), payload)
            except Exception as e:  # noqa: BLE001 — a route must not kill the server
                result = (500, {"error": f"{type(e).__name__}: {e}"[:300]})
            if len(result) == 3:
                code, body, ctype = result
            else:
                code, obj = result
                body, ctype = json.dumps(obj).encode(), "application/json"
        request.send_response(code)
        request.send_header("Content-Type", ctype)
        request.send_header("Content-Length", str(len(body)))
        request.end_headers()
        request.wfile.write(body)


class RunMonitor:
    """Health server + stall watchdog for one Simulator process.

    ``record_round`` is the heartbeat: the engine calls it after every
    completed round attempt (per-round path) or once per fused chunk with
    the amortized per-round duration (the chunk is one device dispatch, so
    per-round wall time inside it is not observable — the watchdog needs a
    cadence estimate, not a measurement).
    """

    def __init__(self, telemetry, port: int = 0, host: str = "0.0.0.0",
                 stall_factor: float = 10.0,
                 stall_grace_seconds: float = 900.0,
                 poll_interval: float = 1.0, history: int = 64):
        self._tel = telemetry
        self._requested_port = int(port)
        self._host = host
        self.stall_factor = float(stall_factor)
        self.stall_grace_seconds = float(stall_grace_seconds)
        self.poll_interval = float(poll_interval)
        self._lock = threading.Lock()
        self._durations: deque[float] = deque(maxlen=history)
        self._last_round: dict[str, Any] | None = None
        # latest drained numerics gauges: fed by the numerics
        # drainer's on_gauges callback, up to numerics_window rounds late
        # on the synchronous path, one round late on the pipelined one
        self._last_numerics: dict[str, float] = {}
        self._last_beat: float | None = None  # monotonic; set by start()
        self._rounds_completed = 0
        self._active = False  # watchdog only arms between run start/end
        self._stalled = False
        self._stall_info: dict[str, Any] = {}
        # graceful-degradation surface: set by the pipelined
        # executor when it demotes to depth-0 — a third health state,
        # distinct from both healthy (200 ok) and stalled (503): the run
        # IS making progress, just without pipelining
        self._degraded: dict[str, Any] | None = None
        # current effective pipeline depth: the configured k
        # at run start, 0 while demoted, back to k on re-promotion; None
        # on non-pipelined executors (gauge absent rather than 0)
        self._pipeline_depth: int | None = None
        # the client mesh's shape, set once at the run's start; None on a
        # meshless run (gauge absent rather than 0): the
        # attackfl_mesh_devices gauge and /last-round's mesh fields
        self._mesh_devices: int | None = None
        self._mesh_strategy: str | None = None
        # the cost model's program profiles (set at each counted
        # program) and the latest mined window per dispatch seam
        self._cost_programs: dict[str, dict[str, Any]] = {}
        self._hotspots: dict[str, dict[str, Any]] = {}
        # cross-run ledger: /runs lists the store's index so a live
        # monitor also answers "how does this run compare to the last
        # ones"; set by the engine when the ledger is enabled
        self._ledger = None
        self._server: JsonHTTPServer | None = None
        self._stop = threading.Event()
        self.port: int | None = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "RunMonitor":
        """Bind the health server (idempotent) and start the watchdog.
        A fixed port that is already taken (another run's monitor?) falls
        back to an ephemeral one — an observability thread must never
        kill the run it observes; the ACTUAL port lands in ``self.port``,
        the startup banner and the run_header."""
        if self._server is not None:
            return self
        self._server = JsonHTTPServer(self._host, self._requested_port,
                                      name="attackfl-monitor-http")
        self._server.route("GET", "/healthz", self._route_healthz)
        self._server.route("GET", "/metrics", self._route_metrics)
        self._server.route("GET", "/last-round", self._route_last_round)
        self._server.route("GET", "/runs", self._route_runs)
        self._server.route("GET", "/programs", self._route_programs)
        self._server.route("GET", "/hotspots", self._route_hotspots)
        self._server.start()
        self.port = self._server.port
        threading.Thread(target=self._watchdog_loop,
                         name="attackfl-monitor-watchdog",
                         daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop()
            self._server = None

    def run_started(self) -> None:
        """Arm the watchdog; the grace window starts counting now."""
        with self._lock:
            self._active = True
            self._stalled = False
            self._last_beat = time.monotonic()

    def run_ended(self) -> None:
        """Disarm the watchdog (a finished run is not a stalled one)."""
        with self._lock:
            self._active = False
            self._stalled = False

    # ------------------------------------------------------------------
    # heartbeat + stall detection
    # ------------------------------------------------------------------

    def record_round(self, metrics: dict[str, Any],
                     duration: float | None = None) -> None:
        """One completed round attempt.  ``duration`` overrides
        ``metrics["seconds"]`` (fused chunks pass elapsed/chunk_len)."""
        if duration is None:
            seconds = metrics.get("seconds")
            duration = float(seconds) if isinstance(seconds, (int, float)) \
                else None
        with self._lock:
            if duration is not None and duration > 0:
                self._durations.append(float(duration))
            self._last_round = {k: v for k, v in metrics.items()
                                if _is_plain(v)}
            self._last_beat = time.monotonic()
            self._rounds_completed += 1
            self._stalled = False
            self._stall_info = {}

    def set_degraded(self, info: dict[str, Any] | None) -> None:
        """Flip the executor-degradation flag (``info`` carries the
        evidence — round, consecutive failures; None = re-promoted)."""
        with self._lock:
            self._degraded = dict(info) if info else None

    def set_pipeline_depth(self, depth: int | None) -> None:
        """Record the pipelined executor's current EFFECTIVE depth (the
        ``attackfl_pipeline_depth`` gauge: configured k while healthy, 0
        while demoted — demote/re-promote transitions call this)."""
        with self._lock:
            self._pipeline_depth = None if depth is None else int(depth)

    def set_mesh(self, devices: int | None, strategy: str | None = None) -> None:
        """Record the run's client-mesh shape (JAX ``set_mesh``,
        monitor.py:303-310): the ``attackfl_mesh_devices`` gauge and
        /last-round's ``mesh_devices`` and ``mesh_strategy``.  None: a
        meshless run (gauge absent)."""
        with self._lock:
            self._mesh_devices = None if devices is None else int(devices)
            self._mesh_strategy = strategy

    def set_cost_model(self, programs: dict[str, dict[str, Any]]) -> None:
        """Record the engine's counted program profiles — called at each
        program's first dispatch; backs /programs and the cost gauges."""
        with self._lock:
            self._cost_programs = dict(programs or {})

    def set_hotspots(self, summary: dict[str, Any]) -> None:
        """Record a closed profiling window's mined summary — called by
        HotspotCapture; keyed by the dispatch-seam program name so a run
        that profiles several seams keeps one latest window per seam.
        Backs /hotspots and the ``attackfl_host_bound_fraction`` gauge."""
        with self._lock:
            self._hotspots[str(summary.get("program") or "?")] = dict(summary)

    def hotspots_report(self) -> dict[str, Any]:
        """``/hotspots`` payload: the latest mined window per seam."""
        with self._lock:
            return {"windows": dict(self._hotspots)}

    def cost_report(self) -> dict[str, Any]:
        """``/programs`` payload: the counted profiles plus a live
        roofline estimate over the rolling-median round cadence (a
        wall-clock denominator — the honest live lower bound; the
        ledger's figure uses the record's device time)."""
        from attackfl_tpu_torch.costmodel.roofline import utilization_summary

        with self._lock:
            programs = {name: dict(p) for name, p in self._cost_programs.items()}
            durations = list(self._durations)
        device_kind = next((p.get("device_kind") for p in programs.values()
                            if p.get("device_kind")), "")
        median = statistics.median(durations) if durations else None
        utilization = (utilization_summary(programs, median, device_kind)
                       if programs else None)
        if utilization is not None and median is not None:
            utilization["denominator"] = "round_seconds_median"
        return {"programs": programs, "device_kind": device_kind,
                "round_seconds_median": median, "utilization": utilization}

    def set_ledger(self, store) -> None:
        """Attach the cross-run ledger store backing ``/runs`` (the store
        serializes its own reads; the monitor never writes to it)."""
        self._ledger = store

    def runs(self, limit: int = 50) -> dict[str, Any]:
        """``/runs`` payload: the newest ledger index entries (newest
        first), or an explanatory stub when no ledger is attached."""
        if self._ledger is None:
            return {"ledger": None, "records": []}
        try:
            entries = self._ledger.index()
        except Exception as e:  # noqa: BLE001 — observational endpoint
            return {"ledger": self._ledger.directory,
                    "error": f"{type(e).__name__}: {e}"[:300],
                    "records": []}
        return {"ledger": self._ledger.directory,
                "count": len(entries),
                "records": list(reversed(entries[-max(int(limit), 1):]))}

    def simulate_hang(self) -> float:
        """Fault injection (``monitor_stall``): rewind the heartbeat past
        the stall threshold and run one watchdog tick, so the stall path
        (503 + ``stall`` event) fires deterministically.  Returns the
        rewind in seconds."""
        seconds = self.stall_threshold_seconds() + 1.0
        with self._lock:
            if self._last_beat is not None:
                self._last_beat -= seconds
        self.check_stall()
        return seconds

    def update_numerics(self, gauges: dict[str, Any]) -> None:
        """Record the latest drained numerics row (non-finite gauges
        arrive as None and are skipped — Prometheus gauges are numbers)."""
        with self._lock:
            self._last_numerics = {
                k: v for k, v in gauges.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}

    def stall_threshold_seconds(self) -> float:
        """Current stall threshold: stall_factor × rolling-median round
        time (floored), or the grace window before any round completed."""
        with self._lock:
            durations = list(self._durations)
        if not durations:
            return max(self.stall_grace_seconds, MIN_STALL_SECONDS)
        return max(self.stall_factor * statistics.median(durations),
                   MIN_STALL_SECONDS)

    def check_stall(self, now: float | None = None) -> bool:
        """One watchdog tick.  ``now`` (monotonic seconds) is injectable so
        tests can simulate a hang without sleeping.  Emits the ``stall``
        event exactly once per healthy→stalled transition."""
        now = time.monotonic() if now is None else now
        threshold = self.stall_threshold_seconds()
        with self._lock:
            if not self._active or self._last_beat is None:
                return False
            since = now - self._last_beat
            if since <= threshold:
                return self._stalled
            transition = not self._stalled
            self._stalled = True
            self._stall_info = {
                "seconds_since_round": round(since, 3),
                "threshold_seconds": round(threshold, 3),
                "rounds_completed": self._rounds_completed,
            }
            info = dict(self._stall_info)
        if transition:
            self._tel.counters.inc("stalls_detected")
            self._tel.events.emit("stall", **info)
            self._tel.events.flush()
        return True

    def _watchdog_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.check_stall()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                pass

    # ------------------------------------------------------------------
    # endpoint payloads
    # ------------------------------------------------------------------

    def health(self) -> tuple[int, dict[str, Any]]:
        """Three distinct states: stalled (503 — no progress at all),
        degraded (200 — progressing without pipelining), healthy (200)."""
        with self._lock:
            if self._stalled:
                return 503, {"status": "stalled", **self._stall_info}
            if self._degraded is not None:
                return 200, {
                    "status": "degraded",
                    "active": self._active,
                    "rounds_completed": self._rounds_completed,
                    **self._degraded,
                }
            return 200, {
                "status": "ok",
                "active": self._active,
                "rounds_completed": self._rounds_completed,
            }

    def last_round(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._last_round or {})
            if self._last_numerics:
                out["numerics"] = dict(self._last_numerics)
            if self._pipeline_depth is not None:
                out["pipeline_depth"] = self._pipeline_depth
            if self._mesh_devices is not None:
                out["mesh_devices"] = self._mesh_devices
                if self._mesh_strategy:
                    out["mesh_strategy"] = self._mesh_strategy
            return out

    def metrics_text(self) -> str:
        """The Counters registry + round/stall gauges in Prometheus text
        exposition format."""
        with self._lock:
            durations = list(self._durations)
            last = dict(self._last_round or {})
            numerics = dict(self._last_numerics)
            rounds = self._rounds_completed
            stalled = int(self._stalled)
            degraded = int(self._degraded is not None)
            pipeline_depth = self._pipeline_depth
            mesh_devices = self._mesh_devices
        lines = [
            "# TYPE attackfl_rounds_completed counter",
            f"attackfl_rounds_completed {rounds}",
            "# TYPE attackfl_stalled gauge",
            f"attackfl_stalled {stalled}",
            "# TYPE attackfl_degraded gauge",
            f"attackfl_degraded {degraded}",
            "# TYPE attackfl_stall_threshold_seconds gauge",
            f"attackfl_stall_threshold_seconds "
            f"{self.stall_threshold_seconds():.6f}",
        ]
        if pipeline_depth is not None:
            lines += [
                "# TYPE attackfl_pipeline_depth gauge",
                f"attackfl_pipeline_depth {pipeline_depth}",
            ]
        if mesh_devices is not None:
            lines += [
                "# TYPE attackfl_mesh_devices gauge",
                f"attackfl_mesh_devices {mesh_devices}",
            ]
        if durations:
            lines += [
                "# TYPE attackfl_round_seconds_median gauge",
                f"attackfl_round_seconds_median "
                f"{statistics.median(durations):.6f}",
            ]
        phases = last.get("phases")
        if isinstance(phases, dict):
            lines.append("# TYPE attackfl_last_round_phase_seconds gauge")
            for phase, dur in phases.items():
                if isinstance(dur, (int, float)):
                    lines.append(
                        f'attackfl_last_round_phase_seconds'
                        f'{{phase="{_sanitize(str(phase))}"}} {dur:.6f}')
        if numerics:
            lines.append("# TYPE attackfl_numerics gauge")
            for name, value in numerics.items():
                lines.append(
                    f'attackfl_numerics{{name="{_sanitize(str(name))}"}} '
                    f'{value:.6g}')
        # the cost model: counted per-program profiles + the live
        # roofline estimate (wall-cadence denominator — see cost_report)
        with self._lock:
            has_programs = bool(self._cost_programs)
        if has_programs:
            report = self.cost_report()
            lines.append("# TYPE attackfl_program_flops gauge")
            lines.append("# TYPE attackfl_program_bytes gauge")
            for name, profile in sorted(report["programs"].items()):
                label = _sanitize(str(name))
                for gauge, key in (("attackfl_program_flops", "flops"),
                                   ("attackfl_program_bytes", "bytes_accessed")):
                    value = profile.get(key)
                    if isinstance(value, (int, float)) and not isinstance(value, bool):
                        lines.append(f'{gauge}{{program="{label}"}} {value:.6g}')
            utilization = report.get("utilization") or {}
            lines.append("# TYPE attackfl_utilization gauge")
            for kind, key in (("flops", "utilization_flops"),
                              ("bytes", "utilization_bytes")):
                value = utilization.get(key)
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    lines.append(f'attackfl_utilization{{kind="{kind}"}} {value:.6g}')
            lines.append("# TYPE attackfl_achieved_per_sec gauge")
            for kind, key in (("flops", "achieved_flops_per_sec"),
                              ("bytes", "achieved_bytes_per_sec")):
                value = utilization.get(key)
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    lines.append(f'attackfl_achieved_per_sec{{kind="{kind}"}} {value:.6g}')
        with self._lock:
            hotspots = {name: dict(window) for name, window in self._hotspots.items()}
        if hotspots:
            lines.append("# TYPE attackfl_host_bound_fraction gauge")
            for program, window in sorted(hotspots.items()):
                value = window.get("host_bound_fraction")
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    lines.append(f'attackfl_host_bound_fraction'
                                 f'{{program="{_sanitize(program)}"}} {value:.6g}')
        counters = self._tel.counters.snapshot()
        if counters:
            lines.append("# TYPE attackfl_counter counter")
            for name, value in counters.items():
                lines.append(
                    f'attackfl_counter{{name="{_sanitize(name)}"}} {value}')
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # http routes (JsonHTTPServer handlers)
    # ------------------------------------------------------------------

    def _route_healthz(self, query, body):
        return self.health()

    def _route_metrics(self, query, body):
        return 200, self.metrics_text().encode(), \
            "text/plain; version=0.0.4"

    def _route_last_round(self, query, body):
        return 200, self.last_round()

    def _route_runs(self, query, body):
        return 200, self.runs()

    def _route_programs(self, query, body):
        return 200, self.cost_report()

    def _route_hotspots(self, query, body):
        return 200, self.hotspots_report()


def _is_plain(value: Any) -> bool:
    """JSON-clean check for /last-round payloads (round metrics are already
    host values, but be defensive about stray arrays)."""
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
