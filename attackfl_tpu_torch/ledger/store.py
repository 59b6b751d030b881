"""Persistent ledger store: append-only JSONL + atomically-published index
(the port's copy of ``attackfl_tpu/ledger/store.py``).

Layout (one directory, shared by every run of an experiment family):

* ``ledger.jsonl`` — one full ledger record per line, append-only.  A
  crash mid-append can tear at most the final line; readers skip torn
  lines and count them, so the store never needs repair.
* ``index.json`` — small per-record summaries for quick listing,
  rewritten on every append by temp + fsync + rename; a missing or stale
  index is rebuilt from ``ledger.jsonl``, the source of truth.

Orphaned ``index.json.tmp*`` temps of killed writes are swept when a
store opens.  :meth:`LedgerStore.append` holds an advisory ``fcntl``
lock on ``ledger.lock`` around the append and the index publish, so
several stores (threads or processes) over one directory never lose a
record.  The format is the JAX package's: its ``ledger`` tools read a
port ledger.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Any

from attackfl_tpu_torch.utils.atomicio import file_lock, write_bytes_atomic

ENV_LEDGER_DIR = "ATTACKFL_LEDGER_DIR"
LEDGER_NAME = "ledger.jsonl"
INDEX_NAME = "index.json"
LOCK_NAME = "ledger.lock"
INDEX_VERSION = 1

# The per-record summary the index carries (and `ledger list` renders):
# the JAX package's fields, so either package's tools read either index.
INDEX_FIELDS = ("record_id", "ts", "run_id", "fingerprint", "executor",
                "source", "mode", "model", "total_clients", "rounds",
                "ok_rounds", "rounds_per_sec_steady", "sweep_id", "cell",
                "pipeline_depth", "pipeline_depth_effective",
                "mesh_devices",
                "sched_priority", "sched_preemptions",
                "sched_wait_seconds", "sched_tenant")


def resolve_ledger_dir(explicit: str | None = None,
                       base: str | None = None) -> str:
    """Ledger directory resolution: the ``ATTACKFL_LEDGER_DIR`` env var
    wins over the config's explicit dir, which wins over ``<base>/ledger``
    (base = the run's telemetry directory)."""
    return (os.environ.get(ENV_LEDGER_DIR) or explicit
            or os.path.join(base or ".", "ledger"))


def _write_json_atomic(path: str, payload: Any) -> None:
    """Temp + fsync + rename publish (utils/atomicio); the pid+uuid temp
    suffix keeps concurrent writers' temps distinct."""
    write_bytes_atomic(
        path, json.dumps(payload).encode(),
        tmp_suffix=f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}")


def sweep_orphans(directory: str, dry_run: bool = False) -> list[str]:
    """Remove ``index.json.tmp*`` / ``ledger.jsonl.tmp*`` leftovers from
    killed writes (only the ledger's own temp patterns — the directory
    may be shared).  Returns the removed (or, with ``dry_run``, the
    matching) paths."""
    removed: list[str] = []
    try:
        names = os.listdir(directory or ".")
    except OSError:
        return removed
    for name in names:
        if not (name.startswith(INDEX_NAME + ".tmp")
                or name.startswith(LEDGER_NAME + ".tmp")):
            continue
        path = os.path.join(directory or ".", name)
        if not dry_run:
            try:
                os.unlink(path)
            except OSError:
                continue
        removed.append(path)
    return removed


class LedgerStore:
    """One ledger directory: append records, query them, keep the index
    honest.  Appends are lock-serialized (the monitor thread reads while
    the round loop's ``_finish_run`` writes)."""

    def __init__(self, directory: str):
        self.directory = directory or "."
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, LEDGER_NAME)
        self.index_path = os.path.join(self.directory, INDEX_NAME)
        self.lock_path = os.path.join(self.directory, LOCK_NAME)
        self._lock = threading.Lock()
        # sweep under the file lock: a store opening while a sibling
        # instance republishes the index must not delete the live temp
        # out from under that writer's os.replace.  The lock file is
        # only materialized when there is something to sweep (or an
        # append happens later) — opening a committed/read-only ledger
        # dir for queries must not litter it.
        if sweep_orphans(self.directory, dry_run=True):
            with file_lock(self.lock_path):
                self.swept_orphans = sweep_orphans(self.directory)
        else:
            self.swept_orphans = []

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def append(self, record: dict[str, Any]) -> str:
        """Append one record; returns its (assigned) ``record_id``.

        The JSONL append lands first (flush+fsync — the record is durable
        before the index names it), then the index is atomically
        republished.  An id collision (same run_id appended twice, e.g.
        bench reps sharing a Simulator) gets a ``-N`` suffix.

        Serialized twice over: the instance lock (monitor thread vs the
        round loop) AND an advisory file lock, because N service workers
        each hold their own store instance over this one directory — the
        index reload, the collision-suffix assignment, the JSONL append
        and the index republish must be one atomic step across all of
        them."""
        with self._lock, file_lock(self.lock_path):
            index = self._load_index_unlocked()
            taken = {e.get("record_id") for e in index}
            rid = str(record.get("record_id") or record.get("run_id")
                      or uuid.uuid4().hex[:12])
            if rid in taken:
                n = 2
                while f"{rid}-{n}" in taken:
                    n += 1
                rid = f"{rid}-{n}"
            record = dict(record, record_id=rid)
            with open(self.path, "a") as fh:
                fh.write(json.dumps(record) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            index.append(self._index_entry(record))
            _write_json_atomic(self.index_path, {
                "index_version": INDEX_VERSION, "records": index})
            return rid

    @staticmethod
    def _index_entry(record: dict[str, Any]) -> dict[str, Any]:
        return {k: record.get(k) for k in INDEX_FIELDS}

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def index(self) -> list[dict[str, Any]]:
        """Per-record summaries, oldest first.  Falls back to (and heals
        from) a full JSONL scan when the index file is missing or behind
        the JSONL (a crash between the two writes)."""
        with self._lock:
            return self._load_index_unlocked()

    def _load_index_unlocked(self) -> list[dict[str, Any]]:
        entries: list[dict[str, Any]] | None = None
        try:
            with open(self.index_path) as fh:
                payload = json.load(fh)
            if isinstance(payload, dict):
                raw = payload.get("records")
                if isinstance(raw, list):
                    entries = [e for e in raw if isinstance(e, dict)]
        except (OSError, json.JSONDecodeError):
            entries = None
        records, _ = self._scan_unlocked()
        if entries is None or len(entries) != len(records):
            # rebuild from the source of truth (missing/torn/stale index)
            entries = [self._index_entry(r) for r in records]
        return entries

    def load(self) -> tuple[list[dict[str, Any]], int]:
        """Every full record (oldest first) plus the count of skipped
        torn/malformed lines."""
        with self._lock:
            return self._scan_unlocked()

    def _scan_unlocked(self) -> tuple[list[dict[str, Any]], int]:
        records: list[dict[str, Any]] = []
        skipped = 0
        try:
            fh = open(self.path)
        except OSError:
            return records, skipped
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    skipped += 1
                    continue
                if isinstance(record, dict):
                    records.append(record)
                else:
                    skipped += 1
        return records, skipped

    def get(self, record_id: str) -> dict[str, Any] | None:
        """Full record by id; unambiguous id prefixes resolve too."""
        records, _ = self.load()
        for record in records:
            if record.get("record_id") == record_id:
                return record
        matches = [r for r in records
                   if str(r.get("record_id", "")).startswith(record_id)]
        return matches[0] if len(matches) == 1 else None

    def records(self, fingerprint: str | None = None) -> list[dict[str, Any]]:
        """Every full record, or those of one config ``fingerprint``."""
        records, _ = self.load()
        return [r for r in records
                if fingerprint is None or r.get("fingerprint") == fingerprint]
