"""Structured JSONL event log: the machine-readable run record (the
port's copy of ``attackfl_tpu/telemetry/events.py``).

Every run appends one JSON object per line to ``events.jsonl``: a
``run_header``, one ``round`` record per executed round (phase
durations, losses, quality metrics, attack and defense decisions),
``chunk`` records from the fused path, ``retry``, ``rollback``,
``checkpoint``, ``fault``, ``degrade``, ``resume``, ``validation`` and
``attribution`` lifecycle events, and a final ``counters`` + ``run_end``
pair.  The schema, its version and the tables of required and optional
fields are the JAX package's, so its jax-free ``metrics`` and ``ledger``
tools and its ``validate_event`` read a port run as they read their own.

Recording is strictly host-side: only values the host already holds are
written.  :func:`_jsonable` refuses a tensor that lives on the card,
since converting one would be a hidden host sync.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any

SCHEMA_VERSION = 14

# Required fields per event kind (beyond the common envelope).  Extra
# fields are always allowed; these are the floor the tooling relies on.
# NOTE: bool is checked before int (bool subclasses int in Python).
_NUM = (int, float)
REQUIRED_FIELDS: dict[str, dict[str, Any]] = {
    "run_header": {"run_id": str, "backend": str, "num_devices": int,
                   "mode": str, "model": str, "data_name": str},
    "round": {"round": int, "broadcast": int, "ok": bool},
    "chunk": {"chunk_len": int, "seconds": _NUM, "includes_compile": bool},
    "compile": {"program": str, "seconds": _NUM},
    "retry": {"round": int, "retries": int},
    "rollback": {"removed": list, "broadcast": int},
    "checkpoint": {"path": str},
    "validation": {"ok": bool},
    "counters": {"counters": dict},
    "run_end": {"rounds": int, "ok_rounds": int, "seconds": _NUM},
    # bench.py's one-line metric contract, emitted through the same schema
    "metric": {"metric": str, "value": _NUM, "unit": str},
    # --- schema v2 kinds ---
    # watchdog: no round completed within the stall threshold
    "stall": {"seconds_since_round": _NUM, "threshold_seconds": _NUM,
              "rounds_completed": int},
    # defense forensics: ground truth vs. the defense's per-round decision
    "attribution": {"round": int, "mode": str, "attackers": list,
                    "kept": list, "removed": list},
    # jax.profiler --profile-rounds window markers
    "profile": {"action": str},
    # --- schema v4 kinds ---
    # fault-injection ground truth (attackfl_tpu/faults): one record per
    # injected failure or supervised recovery
    "fault": {"fault": str, "action": str},
    # pipelined-executor graceful degradation: demoted/repromoted
    "degrade": {"state": str, "round": int},
    # crash-safe resume boundary (manifest-driven `--resume`)
    "resume": {"round": int, "path": str},
    # --- schema v5 kind ---
    # cross-run ledger receipt: this run's distilled record was appended
    # to the persistent ledger (attackfl_tpu/ledger) — the id + file it
    # landed in, so a run directory points at its cross-run history
    "ledger": {"record_id": str, "ledger_path": str},
    # --- schema v6 kinds ---
    # run-service job lifecycle: one record per state transition
    # (attackfl_tpu/service) — submitted/rejected/started/retried/
    # requeued/completed/failed/cancelled
    "job": {"job_id": str, "action": str},
    # the service daemon's own lifecycle: started/replayed/draining/
    # drained/stopped, with crash-recovery replay evidence riding along
    "service": {"action": str},
    # --- schema v7 kind ---
    # scenario-matrix sweep lifecycle: one record per transition
    # (started/chunk/fallback/cell_done/cell_aborted/resumed/
    # interrupted/completed) — the whole (attack x defense x seed) grid
    # is one run record
    "matrix": {"sweep_id": str, "action": str},
    # --- schema v9 kind ---
    # cost-observatory capture (attackfl_tpu/costmodel): one guarded
    # cost/memory-analysis snapshot per compiled program, keyed by
    # program name + config fingerprint.  Every cost field is OPTIONAL
    # (type-checked below when present): a raising backend analysis
    # degrades to a partial profile instead of killing the run
    "program_profile": {"program": str, "fingerprint": str},
    # --- schema v11 kind ---
    # multi-tenant scheduler decision (attackfl_tpu/scheduler): one
    # record per admit/pack/preempt/resume/shed/break, with the
    # decision's evidence as optional typed fields (below)
    "schedule": {"action": str},
    # --- schema v12 kind ---
    # device-slot occupancy transition (attackfl_tpu/scheduler): the
    # fleet observatory's busy/idle ground truth — one acquire when a
    # job lands on a slot, one release (with the measured busy_seconds)
    # when it leaves, whatever the reason (done/failed/preempt/drain)
    "slot": {"slot": int, "action": str},
    # --- schema v13 kind ---
    # scenario-science sweep summary (attackfl_tpu/science): the outcome
    # join's distilled per-defense leaderboard for one finished matrix
    # sweep.  Everything beyond the sweep identity is OPTIONAL (below) —
    # a sweep too small to rank still leaves a record
    "science": {"sweep_id": str},
    # --- schema v14 kind ---
    # hotspot-observatory profiling window (attackfl_tpu/profiler): one
    # record per window closed at an executor dispatch seam.  Only the
    # status is required (ok/unavailable/torn/empty) — a window whose
    # backend refused to start, or whose trace tore, still leaves a
    # loud record.  The mined attribution rides as OPTIONAL typed
    # fields (below)
    "hotspot": {"status": str},
}

# --- schema v14: optional attribution payload on `hotspot` events ---
# (type-checked when present; an `unavailable` window carries only the
# identity + reason, an `ok` window carries the mined compact summary —
# see profiler/mine.compact_summary)
_OPTIONAL_HOTSPOT_FIELDS: dict[str, Any] = {
    "program": str, "round_first": int, "round_last": int,
    "trace": str, "reason": str,
    "wall_us": _NUM, "device_busy_us": _NUM, "op_self_us": _NUM,
    "host_bound_fraction": _NUM, "classification": str,
    "books_close": bool, "lanes": int,
    "top_ops": list, "category_shares": dict,
}

# --- schema v13: optional leaderboard payload on `science` events ---
# (type-checked when present; `leaderboard` rows are the rank.py
# defense-score dicts, `baseline` names the clean-baseline attack-axis
# value damage is measured against)
_OPTIONAL_SCIENCE_FIELDS: dict[str, Any] = {
    "cells": int, "attacks": int, "defenses": int, "seeds": int,
    "baseline": str, "quality_key": str, "leaderboard": list,
}

# --- schema v12: optional occupancy payload on `slot` events ---
# (type-checked when present; a release carries the measured busy time
# and the reason the slot came free; both carry the occupant identity)
_OPTIONAL_SLOT_FIELDS: dict[str, Any] = {
    "job_id": str, "priority": str, "tenant": str, "fleet_id": str,
    "busy_seconds": _NUM, "reason": str,
}

# --- schema v11: optional evidence payload on `schedule` events ---
# (type-checked when present; which fields ride along depends on the
# action — a shed carries backlog + retry-after, a pack carries the
# predicted price, a break carries the attempts evidence)
_OPTIONAL_SCHEDULE_FIELDS: dict[str, Any] = {
    "job_id": str, "priority": str, "predicted_seconds": _NUM,
    "backlog_seconds": _NUM, "retry_after_seconds": _NUM,
    "preemptions": int, "wait_seconds": _NUM, "reason": str,
    # v12: the causal-trace id every decision names, the
    # device slot a pack/resume lands on, and the tenant it bills to
    "fleet_id": str, "slot": int, "tenant": str,
}

# --- schema v9: optional cost payload on `program_profile` events ---
# (type-checked when present; capture emits whichever halves the backend
# provided — see costmodel/capture.compiled_profile)
_OPTIONAL_PROGRAM_PROFILE_FIELDS: dict[str, Any] = {
    "flops": _NUM, "transcendentals": _NUM, "bytes_accessed": _NUM,
    "memory": dict, "rounds_per_dispatch": int, "cells": int,
    "device_kind": str,
}

# --- schema v3: optional numerics payload on `metric` events ---
# (type-checked when present; a v1/v2 metric record carries none of these)
_OPTIONAL_METRIC_FIELDS: dict[str, Any] = {
    "round": int, "broadcast": int, "numerics": dict, "hist": list,
}

# --- schema v5/v6/v7/v8: optional provenance fields on `run_header`
# events (type-checked when present; v1-v4 headers carry none of these;
# monitor_port — the ACTUAL bound port under `monitor-port: 0` — is v6;
# sweep_id/cell — matrix-sweep membership — are v7; pipeline_depth /
# pipeline_depth_configured — the depth-k executor's resolved and
# configured depth — are v8)
_OPTIONAL_RUN_HEADER_FIELDS: dict[str, Any] = {
    "git_rev": str, "jaxlib_version": str, "platform": str,
    "monitor_port": int,
    "sweep_id": str, "cell": str,
    "pipeline_depth": int, "pipeline_depth_configured": str,
    # v10: mesh provenance — the executor's mesh strategy and
    # the device count the ledger's non-peer baseline key reads
    "mesh_strategy": str, "mesh_devices": int,
    # v11: scheduler provenance — priority class, preemption
    # count and queue wait the dispatching scheduler stamped on the run;
    # the ledger mines all three for per-job accounting
    "sched_priority": str, "sched_preemptions": int,
    "sched_wait_seconds": _NUM,
    # v12: fleet-trace provenance — the causal id, device
    # slot and tenant the dispatching scheduler stamped on the run, so
    # a run directory's events join the fleet timeline by construction
    "sched_fleet_id": str, "sched_slot": int, "sched_tenant": str,
}

# Which schema version introduced each kind (the JAX package's table; the
# port's tests hold the two equal).
KINDS_BY_VERSION: dict[int, frozenset[str]] = {
    1: frozenset({"run_header", "round", "chunk", "compile", "retry",
                  "rollback", "checkpoint", "validation", "counters",
                  "run_end", "metric"}),
    2: frozenset({"stall", "attribution", "profile"}),
    3: frozenset(),  # v3 only adds optional fields on `metric`
    4: frozenset({"fault", "degrade", "resume"}),
    5: frozenset({"ledger"}),  # + optional run_header provenance fields
    6: frozenset({"job", "service"}),  # + optional run_header monitor_port
    7: frozenset({"matrix"}),  # + optional run_header sweep_id/cell
    # v8 adds no kinds — only the optional run_header pipeline-depth
    # fields, like v3's optional metric payload
    8: frozenset(),
    # + optional cost payload fields on the new kind itself
    9: frozenset({"program_profile"}),
    # v10 adds no kinds — only the optional run_header mesh fields,
    # like v8's pipeline-depth pair
    10: frozenset(),
    # + optional run_header sched_* fields and the optional evidence
    # payload on the new kind itself
    11: frozenset({"schedule"}),
    # + optional fleet_id/slot/tenant evidence on `schedule`, optional
    # run_header sched_fleet_id/sched_slot/sched_tenant provenance, and
    # the optional occupancy payload on the new kind itself
    12: frozenset({"slot"}),
    # + the optional leaderboard payload on the new kind itself
    13: frozenset({"science"}),
    # + the optional attribution payload on the new kind itself
    14: frozenset({"hotspot"}),
}


def known_kinds(version: int = SCHEMA_VERSION) -> frozenset[str]:
    """Every event kind valid at ``version`` (kinds are only ever added,
    so this is the union over versions <= ``version``)."""
    if version not in KINDS_BY_VERSION:
        raise ValueError(
            f"unknown schema version {version}; have "
            f"{sorted(KINDS_BY_VERSION)}")
    return frozenset().union(
        *(kinds for v, kinds in KINDS_BY_VERSION.items() if v <= version))

_COMMON_FIELDS: dict[str, Any] = {"schema": int, "kind": str, "ts": _NUM}
# Envelope fields that MAY appear (schema v2) and are type-checked when
# present; absent is always valid (v1 files carry neither).
_OPTIONAL_COMMON_FIELDS: dict[str, Any] = {"process_index": int}


def _jsonable(value: Any) -> Any:
    """Best-effort conversion of numpy scalars and arrays and of CPU torch
    tensors to plain Python, so every record round-trips through
    ``json``."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if getattr(value, "is_cuda", False):
        raise TypeError("a CUDA tensor reached the event log: the call site must "
                        "hold a host value (converting here would sync the card)")
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "ndim", None) in (0, None):
        try:
            return item()
        except Exception:  # noqa: BLE001 — fall through to str
            pass
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        try:
            return tolist()
        except Exception:  # noqa: BLE001
            pass
    return str(value)


def validate_event(record: Any) -> list[str]:
    """Return a list of schema violations for one decoded event (empty =
    valid).  Checks the common envelope, the kind, and the kind's required
    fields/types; extra fields are allowed by design."""
    if not isinstance(record, dict):
        return [f"event is not an object: {type(record).__name__}"]
    errors: list[str] = []
    for name, typ in _COMMON_FIELDS.items():
        if name not in record:
            errors.append(f"missing common field '{name}'")
        elif typ is int and isinstance(record[name], bool):
            errors.append(f"field '{name}' must be int, got bool")
        elif not isinstance(record[name], typ):
            errors.append(
                f"field '{name}' has type {type(record[name]).__name__}")
    for name, typ in _OPTIONAL_COMMON_FIELDS.items():
        if name in record and (isinstance(record[name], bool)
                               or not isinstance(record[name], typ)):
            errors.append(f"field '{name}' must be {typ.__name__}, got "
                          f"{type(record[name]).__name__}")
    kind = record.get("kind")
    if isinstance(kind, str):
        required = REQUIRED_FIELDS.get(kind)
        if required is None:
            errors.append(f"unknown event kind '{kind}'")
        else:
            for name, typ in required.items():
                if name not in record:
                    errors.append(f"[{kind}] missing field '{name}'")
                    continue
                value = record[name]
                if typ is bool:
                    if not isinstance(value, bool):
                        errors.append(f"[{kind}] '{name}' must be bool")
                elif typ is int:
                    if isinstance(value, bool) or not isinstance(value, int):
                        errors.append(f"[{kind}] '{name}' must be int")
                elif typ == _NUM:
                    if isinstance(value, bool) or not isinstance(value, _NUM):
                        errors.append(f"[{kind}] '{name}' must be a number")
                elif not isinstance(value, typ):
                    errors.append(
                        f"[{kind}] '{name}' must be {typ.__name__}, got "
                        f"{type(value).__name__}")
        if kind == "metric":
            for name, typ in _OPTIONAL_METRIC_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[metric] '{name}' must be {typ.__name__}, got "
                        f"{type(record[name]).__name__}")
        if kind == "run_header":
            for name, typ in _OPTIONAL_RUN_HEADER_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[run_header] '{name}' must be {typ.__name__}, got "
                        f"{type(record[name]).__name__}")
        if kind == "program_profile":
            for name, typ in _OPTIONAL_PROGRAM_PROFILE_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[program_profile] '{name}' has type "
                        f"{type(record[name]).__name__}")
        if kind == "schedule":
            for name, typ in _OPTIONAL_SCHEDULE_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[schedule] '{name}' has type "
                        f"{type(record[name]).__name__}")
        if kind == "slot":
            for name, typ in _OPTIONAL_SLOT_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[slot] '{name}' has type "
                        f"{type(record[name]).__name__}")
        if kind == "science":
            for name, typ in _OPTIONAL_SCIENCE_FIELDS.items():
                if name in record and (isinstance(record[name], bool)
                                       or not isinstance(record[name], typ)):
                    errors.append(
                        f"[science] '{name}' has type "
                        f"{type(record[name]).__name__}")
        if kind == "hotspot":
            for name, typ in _OPTIONAL_HOTSPOT_FIELDS.items():
                if name not in record:
                    continue
                value = record[name]
                if typ is bool:
                    if not isinstance(value, bool):
                        errors.append(f"[hotspot] '{name}' must be bool")
                elif isinstance(value, bool) or not isinstance(value, typ):
                    errors.append(
                        f"[hotspot] '{name}' has type "
                        f"{type(value).__name__}")
    schema = record.get("schema")
    if isinstance(schema, int) and schema > SCHEMA_VERSION:
        errors.append(f"schema version {schema} is newer than "
                      f"{SCHEMA_VERSION}; update the tooling")
    return errors


def metric_line(metric: str, value: float, unit: str = "rounds/s",
                **extra: Any) -> dict[str, Any]:
    """Build bench.py's one-line JSON metric record in the telemetry
    schema.  Key order keeps the historical contract (metric/value/unit
    first) with the schema envelope appended."""
    record: dict[str, Any] = {"metric": metric, "value": _jsonable(value),
                              "unit": unit}
    record.update({k: _jsonable(v) for k, v in extra.items()})
    record.setdefault("schema", SCHEMA_VERSION)
    record.setdefault("kind", "metric")
    record.setdefault("ts", round(time.time(), 6))
    return record


class EventLog:
    """Append-only JSONL writer for one run (line-buffered, so partial
    runs still leave a usable record), one process's, under a fresh
    ``run_id`` or the given one.  ``process_index``, given in a run over
    several processes, is stamped into every record, whose ``run_id`` is
    then process 0's, shared, so that ``metrics --merge`` correlates the
    per-process files (JAX events.py:574-602).  Writes are
    lock-serialized: the async checkpoint writer's thread emits beside the
    round loop."""

    enabled = True

    def __init__(self, path: str, sample_every: int = 1, run_id: str | None = None,
                 process_index: int | None = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.sample_every = max(int(sample_every), 1)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.process_index = process_index
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)

    def emit(self, kind: str, **fields: Any) -> dict[str, Any]:
        record: dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "kind": kind,
            "ts": round(time.time(), 6),
            "run_id": self.run_id,
        }
        if self.process_index is not None:
            record["process_index"] = int(self.process_index)
        for key, value in fields.items():
            record[key] = _jsonable(value)
        with self._lock:
            self._fh.write(json.dumps(record) + "\n")
        return record

    def round_event(self, metrics: dict[str, Any]) -> None:
        """Record one round, honoring ``sample_every`` (failed rounds and
        round 1 — the compile round — are always recorded)."""
        rnd = int(metrics.get("round", 0))
        ok = bool(metrics.get("ok", True))
        if (self.sample_every > 1 and ok and rnd != 1
                and rnd % self.sample_every != 0):
            return
        self.emit("round", **metrics)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        try:
            self._fh.close()
        except Exception:  # noqa: BLE001 — double-close etc. is harmless
            pass


class NullEventLog:
    """Disabled-telemetry stand-in: no file, every method a no-op."""

    enabled = False
    path = None
    run_id = "disabled"
    process_index = None
    sample_every = 1

    def emit(self, kind: str, **fields: Any) -> dict[str, Any]:
        return {}

    def round_event(self, metrics: dict[str, Any]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
