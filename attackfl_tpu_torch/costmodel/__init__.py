"""The cost model (the port's copy of ``attackfl_tpu/costmodel``).

* **capture** (:mod:`~attackfl_tpu_torch.costmodel.capture`, the only
  torch-using module here) — each program counted on its first dispatch
  (flops, transcendentals, bytes, memory), emitted as schema-v9
  ``program_profile`` events keyed by program name + config fingerprint
  and folded into the cross-run ledger record;
* **utilization** (:mod:`~attackfl_tpu_torch.costmodel.roofline` +
  :mod:`~attackfl_tpu_torch.costmodel.peaks`) — the profile combined with
  the ledger's measured ``round_device_time`` into achieved FLOP/s and
  bytes/s and, on the H100, roofline utilization fractions (the CPU
  reports achieved-only);
* **prediction** (:mod:`~attackfl_tpu_torch.costmodel.estimate`) —
  ``python -m attackfl_tpu_torch cost estimate`` prices a config without
  running it (fingerprint-peer ledger records first, a flops/bytes
  regression as the fallback) and ``cost validate`` replays predictions
  against a ledger corpus.

Everything here is observational: no host sync is added and params are
bit-identical with the cost model on or off.  The readers import no
torch, so ``metrics --programs`` and the ledger run wherever the files
are.
"""

from attackfl_tpu_torch.costmodel.peaks import peak_for
from attackfl_tpu_torch.costmodel.roofline import per_round_cost, utilization_summary

__all__ = ["peak_for", "per_round_cost", "utilization_summary"]
