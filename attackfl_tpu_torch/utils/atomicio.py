"""Durable-file primitives (the port's copy of
``attackfl_tpu/utils/atomicio.py:42-66,110-129``).

A file is published by writing a temp, ``fsync``-ing it and renaming it
onto the final name, so a kill at any instant leaves either the old
complete file or the new complete one, never a half-written mix.
:func:`file_lock` serializes writers of one ledger directory.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os


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
