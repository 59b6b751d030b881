"""Hotspot windows (the port's copy of ``attackfl_tpu/profiler``).

* **capture** (:mod:`attackfl_tpu_torch.profiler.capture`) —
  ``torch.profiler`` windows at every executor's dispatch seam (sync /
  fused / pipelined), fail-open, each closed window mined into a
  schema-v14 ``hotspot`` event;
* **mine** (:mod:`attackfl_tpu_torch.profiler.mine`, stdlib gzip+json) —
  Chrome-trace ``*.trace.json.gz`` files -> per-op device-time
  attribution grouped by program, under the books-close invariant
  Σ op self-time <= device busy <= wall x lanes;
* **join** (:mod:`attackfl_tpu_torch.ledger.record` + ``hotspots diff``)
  — measured per-program device time reconciled against the cost
  model's prediction (``hotspot_prediction_error_factor``).

CLI: ``python -m attackfl_tpu_torch hotspots [show|diff] [--json]``
(:mod:`attackfl_tpu_torch.profiler.cli`).
"""

from attackfl_tpu_torch.profiler.mine import (  # noqa: F401
    HOST_BOUND_THRESHOLD,
    hotspots_from_events,
    mine_profile_dir,
    mine_trace,
    op_category,
)
