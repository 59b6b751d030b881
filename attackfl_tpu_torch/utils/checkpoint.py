"""Checkpoint and resume (the port's ``attackfl_tpu/utils/checkpoint.py``).

The reference ``torch.save``s the global state to ``{model}.pth`` after
every successful round and reloads it at startup (server.py:144-163,
549-553,578-586).  The port keeps that name and saves the whole
simulation state: global params, the genuine-leak pool, the round
counters and the round generator's state, as one ``torch.save`` dict of
tensors and Python scalars, read back with ``weights_only=True``.

:class:`CheckpointManager` adds the JAX package's durability layer:

* every save lands as a round-stamped entry ``{stem}.r<round>.pth`` and
  the legacy ``{model}.pth`` alias, recorded in an atomically published
  ``manifest.json`` (round, broadcast, file, sha256, bytes, ts) with
  last-``keep`` retention;
* writes retry with exponential backoff and then FAIL OPEN: a logged
  warning, the previous entry survives, and training goes on;
* :meth:`CheckpointManager.load_latest` checks each entry's length, hash
  and structure, newest first, and falls back past a torn one;
* :func:`sweep_orphans` removes the temp files of killed writes;
* a fault plan's host-side injector (``faults/inject.HostFaultInjector``)
  is consulted at the top of every write attempt and after an entry is
  recorded (JAX checkpoint.py:229-230,255-259).

:class:`AsyncCheckpointWriter` (JAX checkpoint.py:355-499) moves the
serialization, the write and the fsync to one supervised daemon thread.

Only entries named ``{stem}.*.pth`` are taken, so a JAX run's
``.msgpack`` entries in the same manifest are skipped, never loaded.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import logging
import os
import threading
import time
from typing import Any, Callable

import torch

from attackfl_tpu_torch.utils.atomicio import content_hash
from attackfl_tpu_torch.utils.atomicio import write_bytes_atomic as _write_bytes

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
SUFFIX = ".pth"
log = logging.getLogger("attackfl_tpu_torch")


def to_bytes(state: dict[str, Any]) -> bytes:
    """Serialize a state dict (tensors are copied to the host first)."""
    host = _map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, state)
    buf = io.BytesIO()
    torch.save(host, buf)
    return buf.getvalue()


def save_state(path: str, state: dict[str, Any]) -> None:
    _write_bytes(path, to_bytes(state))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _check_structure(loaded: Any, template: Any, where: str = "") -> None:
    """Raise ValueError unless ``loaded`` has ``template``'s keys, and its
    tensors the template's shapes and dtypes."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"keys at {where or '/'}: {got} != {sorted(template)}")
        for key in template:
            _check_structure(loaded[key], template[key], f"{where}/{key}")
    elif isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"{where}: a tensor was expected, got {type(loaded).__name__}")
        if loaded.shape != template.shape or loaded.dtype != template.dtype:
            raise ValueError(f"{where}: {tuple(loaded.shape)} {loaded.dtype} != "
                             f"{tuple(template.shape)} {template.dtype}")
    elif type(loaded) is not type(template):
        raise ValueError(f"{where}: {type(loaded).__name__} != {type(template).__name__}")


def load_state_bytes(data: bytes, template: dict[str, Any], path: str = "<bytes>",
                     device: str | torch.device = "cpu") -> dict[str, Any]:
    """Deserialize checkpoint bytes and check them against ``template``
    (a state of the same config); ValueError on any mismatch."""
    try:
        loaded = torch.load(io.BytesIO(data), weights_only=True, map_location=device)
    except Exception as e:  # noqa: BLE001 — a torn zip or a foreign format
        raise ValueError(f"checkpoint {path!r} is not a readable state: {e}") from e
    try:
        _check_structure(loaded, template)
    except ValueError as e:
        raise ValueError(
            f"checkpoint {path!r} does not match the current state structure "
            f"({e}); rerun with the original settings or delete the checkpoint") from e
    return loaded


def load_state(path: str, template: dict[str, Any],
               device: str | torch.device = "cpu") -> dict[str, Any]:
    with open(path, "rb") as fh:
        data = fh.read()
    return load_state_bytes(data, template, path, device)


def sweep_orphans(directory: str) -> list[str]:
    """Remove the temp files (``*.pth.tmp*`` / ``manifest.json.tmp*``) of
    killed or failed writes.  Only these patterns: the checkpoint
    directory defaults to the working directory.  Returns the removed
    paths."""
    removed: list[str] = []
    try:
        names = os.listdir(directory or ".")
    except OSError:
        return removed
    for name in names:
        if SUFFIX + ".tmp" not in name and not name.startswith(MANIFEST_NAME + ".tmp"):
            continue
        path = os.path.join(directory or ".", name)
        try:
            os.unlink(path)
        except OSError:
            continue
        removed.append(path)
    return removed


@dataclasses.dataclass
class LoadResult:
    """What :meth:`CheckpointManager.load_latest` found: the state (None
    when no entry survived the checks), its manifest entry, every newer
    ``(entry, reason)`` it rejected, and the manifest."""

    state: Any
    entry: dict[str, Any] | None
    rejected: list[tuple[dict[str, Any], str]]
    manifest: dict[str, Any] | None


class CheckpointManager:
    """Round-stamped, manifest-tracked checkpoints around the legacy
    single-file contract.

    Each write lands as a round-stamped entry beside the ``{model}.pth``
    alias (a hardlink of the entry, or a second atomic write where links
    fail); then ``manifest.json`` is replaced atomically with
    last-``keep`` retention.  ``fresh=True`` (a run that neither resumes
    nor loads) drops the entries of an earlier manifest: they belong to
    another trajectory.  A write is tried ``retries + 1`` times with
    exponential backoff (base ``backoff`` seconds) and then fails open."""

    def __init__(self, path: str, *, fingerprint: str = "", keep: int = 3,
                 retries: int = 3, backoff: float = 0.05, fresh: bool = True,
                 injector=None, telemetry=None):
        self.path = path
        self.directory = os.path.dirname(path) or "."
        stem = os.path.basename(path)
        self.stem = stem[:-len(SUFFIX)] if stem.endswith(SUFFIX) else stem
        self.fingerprint = fingerprint
        self.keep = max(int(keep), 1)
        self.retries = max(int(retries), 0)
        self.backoff = float(backoff)
        self._entries: list[dict[str, Any]] | None = None
        self._fresh = fresh
        self._injector = injector
        self._tel = telemetry
        self.write_failures = 0

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def read_manifest(self) -> dict[str, Any] | None:
        """The manifest on disk, or None when absent or corrupt (then the
        alias is still a valid resume source)."""
        try:
            with open(self.manifest_path) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        return manifest if isinstance(manifest, dict) else None

    def _own(self, entries: list) -> list[dict[str, Any]]:
        """This base's ``.pth`` entries: one directory may hold several
        models, and a JAX run's ``.msgpack`` ones."""
        return [e for e in entries if isinstance(e, dict)
                and str(e.get("file", "")).startswith(self.stem + ".")
                and str(e.get("file", "")).endswith(SUFFIX)]

    def _load_entries(self) -> list[dict[str, Any]]:
        if self._entries is None:
            manifest = None if self._fresh else self.read_manifest()
            self._entries = self._own(list((manifest or {}).get("entries", [])))
        return self._entries

    def _entry_file(self, round_no: int) -> str:
        return f"{self.stem}.r{round_no:08d}{SUFFIX}"

    def _publish_manifest(self) -> None:
        manifest = {
            "version": MANIFEST_VERSION,
            "base": os.path.basename(self.path),
            "fingerprint": self.fingerprint,
            "updated": round(time.time(), 6),
            "entries": self._entries or [],
        }
        _write_bytes(self.manifest_path, (json.dumps(manifest, indent=1) + "\n").encode())

    def write(self, state: dict[str, Any], meta: dict[str, Any]) -> bool:
        """Serialize and durably publish ``state`` as the entry of
        ``meta["round"]``.  Returns True when it is on disk, False on the
        fail-open path."""
        data = to_bytes(state)
        round_no = int(meta.get("round", 0))
        entry_name = self._entry_file(round_no)
        entry_path = os.path.join(self.directory, entry_name)
        delay = self.backoff
        for attempt in range(1, self.retries + 2):
            try:
                if self._injector is not None:
                    self._injector.on_checkpoint_write(round_no)
                os.makedirs(self.directory, exist_ok=True)
                _write_bytes(entry_path, data)
                break
            except OSError as e:
                if attempt > self.retries:
                    # fail open: persistence degrades, training survives
                    self.write_failures += 1
                    log.warning("checkpoint %s (round %d) not written after %d "
                                "attempts: %s: %s; the previous entry stays",
                                entry_path, round_no, attempt, type(e).__name__, e)
                    if self._tel is not None:
                        self._tel.counters.inc("checkpoint_write_failures")
                        self._tel.events.emit("checkpoint", path=entry_path, round=round_no,
                                              durable=False,
                                              error=f"{type(e).__name__}: {e}"[:300])
                    sweep_orphans(self.directory)
                    return False
                log.warning("checkpoint write attempt %d failed (%s: %s); retrying "
                            "in %.3f s", attempt, type(e).__name__, e, delay)
                if self._tel is not None:
                    self._tel.counters.inc("checkpoint_write_retries")
                    self._tel.events.emit("retry", round=round_no, retries=attempt,
                                          reason="checkpoint_write",
                                          error=f"{type(e).__name__}: {e}"[:300],
                                          backoff_seconds=round(delay, 6))
                time.sleep(delay)
                delay *= 2
        self._publish_alias(entry_path, data)
        self._record_entry(round_no, entry_name, data, meta)
        if self._injector is not None:
            # a torn entry is torn after it was recorded: the manifest
            # keeps the honest hash, which the load checks against
            self._injector.after_checkpoint_write(round_no, entry_path)
        if self._tel is not None:
            self._tel.counters.inc("checkpoint_writes")
        return True

    def _publish_alias(self, entry_path: str, data: bytes) -> None:
        """Point ``{model}.pth`` at the new entry: a hardlink where the
        filesystem allows (one data write, two names), else a second
        atomic write."""
        tmp = self.path + ".alias" + SUFFIX + ".tmp"
        try:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            os.link(entry_path, tmp)
            os.replace(tmp, self.path)
        except OSError:
            _write_bytes(self.path, data)

    def _record_entry(self, round_no: int, entry_name: str, data: bytes,
                      meta: dict[str, Any]) -> None:
        # entries at or after this round are stale (a resume re-ran them)
        entries = [e for e in self._load_entries() if int(e.get("round", 0)) < round_no]
        entries.append({
            "round": round_no,
            "broadcast": int(meta.get("broadcast", round_no)),
            "file": entry_name,
            "sha256": content_hash(data),
            "bytes": len(data),
            "ts": round(time.time(), 6),
        })
        dropped, self._entries = entries[:-self.keep], entries[-self.keep:]
        self._publish_manifest()
        for old in dropped:
            try:
                os.unlink(os.path.join(self.directory, str(old["file"])))
            except OSError:
                pass

    def load_latest(self, template: dict[str, Any],
                    device: str | torch.device = "cpu") -> LoadResult:
        """Restore the newest VALID manifest entry.  Entries are tried
        newest first; each must match its recorded length and sha256 and
        ``template``'s structure.  With no manifest, the alias is the only
        candidate."""
        manifest = self.read_manifest()
        rejected: list[tuple[dict[str, Any], str]] = []
        for entry in reversed(self._own(list((manifest or {}).get("entries", [])))):
            path = os.path.join(self.directory, str(entry.get("file", "")))
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError as e:
                rejected.append((entry, f"unreadable: {e}"))
                continue
            if len(data) != int(entry.get("bytes", -1)):
                rejected.append((entry, f"torn/truncated: {len(data)} bytes on disk vs "
                                        f"{entry.get('bytes')} recorded"))
                continue
            if content_hash(data) != entry.get("sha256"):
                rejected.append((entry, "content hash mismatch"))
                continue
            try:
                state = load_state_bytes(data, template, path, device)
            except ValueError as e:
                rejected.append((entry, f"structure mismatch: {e}"))
                continue
            return LoadResult(state, entry, rejected, manifest)
        if manifest is None and os.path.exists(self.path):
            try:
                state = load_state(self.path, template, device)
            except (OSError, ValueError) as e:
                rejected.append(({"file": os.path.basename(self.path)},
                                 f"legacy checkpoint unreadable: {e}"))
            else:
                return LoadResult(state, {"file": os.path.basename(self.path),
                                          "round": None, "legacy": True}, rejected, None)
        return LoadResult(None, None, rejected, manifest)


def host_snapshot(state: dict[str, Any]) -> dict[str, Any]:
    """A copy of ``state`` on the host that nothing writes to later, the
    copy finished when it returns.  A device tensor's ``.cpu()`` is such
    a copy; a CPU tensor (whose ``.cpu()`` is the tensor itself) is deep
    copied, the views of one storage onto one copied storage, so the
    snapshot serializes to the bytes the state itself would."""
    memo: dict[int, Any] = {}

    def snap(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cpu":
            return x.detach().cpu()
        return copy.deepcopy(x.detach(), memo)

    return _map(snap, state)


class AsyncCheckpointWriter:
    """Background checkpoint persistence with last-write-wins coalescing
    and a thread supervisor (JAX checkpoint.py:355-499).

    The round loop calls :meth:`submit` with a host snapshot
    (:func:`host_snapshot`); serialization, the write and the fsync run on
    one daemon thread, which never touches the card.  The pending slot
    holds one state: a submit while a write is queued replaces the queued
    state (a checkpoint is a full snapshot, so only the newest matters;
    the skip is counted in ``writes_coalesced``).  :meth:`drain` blocks
    until everything submitted is on disk; :meth:`close` drains and stops
    the thread and is safe to call twice.  An error of the write function
    is raised on the next submit, drain or close.

    ``write_fn(path, state, meta)`` replaces the default serialize and
    write (the engine passes the :class:`CheckpointManager`'s write,
    which retries and fails open).  A dead thread, killed through
    :meth:`inject_thread_death` or by a bug, is restarted by the
    supervisor (``_ensure_thread``) on the next submit, drain or close,
    with the pending snapshot intact; ``on_restart(restarts)`` is told."""

    def __init__(self, write_fn: Callable[[str, Any, dict], Any] | None = None,
                 on_restart: Callable[[int], None] | None = None):
        self._cond = threading.Condition()
        self._pending: tuple[str, Any, dict] | None = None
        self._writing = False
        self._closed = False
        self._crash = False
        self._error: BaseException | None = None
        self._write_fn = write_fn
        self._on_restart = on_restart
        self.writes_completed = 0
        self.writes_coalesced = 0
        self.restarts = 0
        self._thread = self._spawn_thread()

    def _spawn_thread(self) -> threading.Thread:
        thread = threading.Thread(target=self._loop, name="attackfl-torch-ckpt-writer",
                                  daemon=True)
        thread.start()
        return thread

    def _ensure_thread(self) -> None:
        """The supervisor: restart a dead writer thread that was not
        closed.  The caller holds the lock; the pending snapshot stays."""
        if self._closed or self._thread.is_alive():
            return
        self.restarts += 1
        self._writing = False
        self._crash = False
        self._thread = self._spawn_thread()
        if self._on_restart is not None:
            self._on_restart(self.restarts)

    def inject_thread_death(self) -> None:
        """The writer thread exits as if it crashed; pending work stays
        queued for the restarted thread."""
        with self._cond:
            self._crash = True
            self._cond.notify_all()

    def _write(self, path: str, state: Any, meta: dict) -> None:
        if self._write_fn is not None:
            self._write_fn(path, state, meta)
            return
        # a temp suffix of its own: a synchronous save to the same path
        # must not clobber this write's temp
        _write_bytes(path, to_bytes(state), tmp_suffix=f"{SUFFIX}.tmp.async{id(self):x}")

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed and not self._crash:
                    self._cond.wait()
                if self._crash:
                    return
                if self._pending is None and self._closed:
                    return
                path, state, meta = self._pending
                self._pending = None
                self._writing = True
            try:
                self._write(path, state, meta)
            except BaseException as e:  # noqa: BLE001 — raised on the next call
                with self._cond:
                    self._error = e
                    self._writing = False
                    self._cond.notify_all()
                continue
            with self._cond:
                self.writes_completed += 1
                self._writing = False
                self._cond.notify_all()

    def _check_error(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from error

    def submit(self, path: str, state: Any, meta: dict[str, Any] | None = None) -> None:
        """Queue ``state`` (a host snapshot) for ``path`` and return."""
        with self._cond:
            self._check_error()
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            self._ensure_thread()
            if self._pending is not None:
                self.writes_coalesced += 1
            self._pending = (path, state, dict(meta or {}))
            self._cond.notify_all()

    def drain(self) -> None:
        """Block until every submitted state is written."""
        with self._cond:
            self._ensure_thread()
            while self._pending is not None or self._writing:
                self._cond.wait(timeout=0.5)
                self._ensure_thread()
            self._check_error()

    def close(self) -> None:
        """Drain and stop the writer thread.  Safe to call twice."""
        with self._cond:
            if self._closed and not self._thread.is_alive():
                return
            self._ensure_thread()
            self._closed = True
            self._cond.notify_all()
        self._thread.join()
        self._check_error()


def checkpoint_path(cfg, base_dir: str | None = None) -> str:
    """The reference's naming (server.py:145-146): ``{model}.pth``, or
    ``{model}_hyper_{clients}.pth`` in hyper mode."""
    base = base_dir or cfg.checkpoint_dir
    if cfg.mode == "hyper":
        name = f"{cfg.model}_hyper_{cfg.total_clients}{SUFFIX}"
    else:
        name = f"{cfg.model}{SUFFIX}"
    return os.path.join(base, name)
