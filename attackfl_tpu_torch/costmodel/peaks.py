"""Peak-spec table: what the silicon could do, per device kind (the
port's copy of ``attackfl_tpu/costmodel/peaks.py``, with the card's row in
place of the TPU rows).

Per-card dense peak FLOP/s and HBM bandwidth for the device kinds the
port runs on, keyed by a lowercase substring of the device name
(``torch.cuda.get_device_name``).  The roofline layer divides achieved
FLOP/s and bytes/s by these to get utilization fractions.

The one row is the NVIDIA H100 SXM5 (``NVIDIA H100 80GB HBM3``, 700 W),
from NVIDIA's H100 datasheet: 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM.  The flops figure is the float32 one because
the port computes in float32 with TF32 pinned off
(``device.resolve_device``).  A card set below 700 W runs slower than
these peaks.  ``chip_smoke.py`` takes its roofline bounds from this row.

**Extending the table for a new device type**: add one entry mapping a
lowercase substring of its name to its ``flops_per_sec`` /
``bytes_per_sec`` (from the vendor spec sheet).  Kinds with no entry
(the CPU above all) report ACHIEVED-only: a shared, frequency-scaled host
has no honest peak.
"""

from __future__ import annotations

from typing import Any

# lowercase device-name substring -> per-card peak spec.  Ordered
# longest-match-first at lookup.
PEAK_SPECS: dict[str, dict[str, float]] = {
    "h100 80gb hbm3": {"flops_per_sec": 67e12, "bytes_per_sec": 3.35e12},
}
# the card's row under its own name, for the roofline bounds
H100 = PEAK_SPECS["h100 80gb hbm3"]


def peak_for(device_kind: Any) -> dict[str, float] | None:
    """The peak spec for a ``device_kind`` string, or None for kinds with
    no honest peak (CPU, unknown accelerators) — callers then report
    achieved-only."""
    if not isinstance(device_kind, str) or not device_kind:
        return None
    kind = device_kind.lower()
    for key in sorted(PEAK_SPECS, key=len, reverse=True):
        if key in kind:
            return dict(PEAK_SPECS[key])
    return None
