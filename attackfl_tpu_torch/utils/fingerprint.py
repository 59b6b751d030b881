"""Config fingerprinting (the port's copy of
``attackfl_tpu/utils/fingerprint.py:26-56``).

A stable short hash of the config fields that shape the checkpointed
state, recorded in the checkpoint manifest and compared at resume.  The
port's ``Config`` has the JAX package's fields, so one config gives both
packages the same 16 hex digits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

# Config fields that never change the checkpointed state's structure or
# trajectory: left out of the fingerprint so that re-pointing a log
# directory or turning an executor on never refuses a legitimate resume.
FINGERPRINT_VOLATILE = frozenset({
    "log_path", "checkpoint_dir", "compile_cache_dir", "telemetry",
    "num_round", "load_parameters", "resume", "faults", "checkpoint_async",
    "checkpoint_keep", "pipeline", "pipeline_depth",
    "pipeline_demote_after",
    "pipeline_repromote_after", "validation_every", "validation_async",
    "reload_parameters_per_round", "service",
})


def fingerprint_from_dict(raw: dict[str, Any]) -> str:
    """Fingerprint a config in dict form (``dataclasses.asdict`` output or
    its JSON round trip: tuples render as lists either way)."""
    raw = dict(raw)
    for name in FINGERPRINT_VOLATILE:
        raw.pop(name, None)
    blob = json.dumps(raw, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def config_fingerprint(cfg: Any) -> str:
    """Stable short hash of the config fields that shape the state.  A
    mismatch at resume means the checkpoint was written under another
    experiment (model, mode, client count, ...)."""
    return fingerprint_from_dict(dataclasses.asdict(cfg))
