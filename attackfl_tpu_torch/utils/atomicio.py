"""Durable-file primitives (the port's copy of
``attackfl_tpu/utils/atomicio.py``).

A file is published by writing a temp, ``fsync``-ing it and renaming it
onto the final name, so a kill at any instant leaves either the old
complete file or the new complete one, never a half-written mix.
:func:`file_lock` serializes writers of one ledger directory.

The run service's queue publishes **sealed JSON**: :func:`write_sealed_json`
stores a sha256 of the canonical payload beside the payload and
:func:`read_sealed_json` verifies it, so a torn or tampered entry is
detected rather than deserialized.  The format is the JAX package's byte
for byte: either package reads the other's spool.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
from typing import Any

SEAL_VERSION = 1


def content_hash(data: bytes) -> str:
    """The manifest's content-hash contract (hex sha256)."""
    return hashlib.sha256(data).hexdigest()


def write_bytes_atomic(path: str, data: bytes, tmp_suffix: str = ".tmp") -> None:
    """Durable atomic publish: write a temp file, fsync it, rename.  A
    failure mid-write unlinks its own temp, so crashes cannot pile up
    orphans (the startup orphan sweep catches hard kills)."""
    tmp = path + tmp_suffix
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json_atomic(path: str, payload: Any, tmp_suffix: str = ".tmp") -> None:
    """JSON over :func:`write_bytes_atomic` (the service's discovery file)."""
    write_bytes_atomic(path, (json.dumps(payload) + "\n").encode(), tmp_suffix=tmp_suffix)


def _canonical(payload: Any) -> bytes:
    return json.dumps(payload, sort_keys=True).encode()


def write_sealed_json(path: str, payload: Any, tmp_suffix: str = ".tmp") -> None:
    """Publish ``payload`` wrapped in a content-hash seal (read back with
    :func:`read_sealed_json`)."""
    wrapper = {"seal": SEAL_VERSION, "sha256": content_hash(_canonical(payload)),
               "payload": payload}
    write_bytes_atomic(path, (json.dumps(wrapper) + "\n").encode(), tmp_suffix=tmp_suffix)


def read_sealed_json(path: str) -> tuple[Any | None, str | None]:
    """A sealed entry: ``(payload, None)`` when the seal verifies, ``(None,
    reason)`` when the file is missing, torn (its JSON cut off), or its
    recorded hash no longer matches the payload."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        return None, f"unreadable: {e}"
    try:
        wrapper = json.loads(data.decode("utf-8", errors="replace"))
    except ValueError as e:
        return None, f"torn/not JSON: {e}"
    if not isinstance(wrapper, dict) or "payload" not in wrapper:
        return None, "not a sealed entry"
    payload = wrapper["payload"]
    if wrapper.get("sha256") != content_hash(_canonical(payload)):
        return None, "content hash mismatch"
    return payload, None


@contextlib.contextmanager
def file_lock(path: str):
    """Advisory exclusive lock on ``path`` (created on demand), held for
    the ``with`` block.  ``fcntl.flock`` locks the open file description,
    so two handles in one process exclude each other as two processes
    do."""
    fh = open(path, "a+")
    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        yield
    finally:
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
        finally:
            fh.close()
