"""Observability (the port's ``attackfl_tpu/telemetry``): console and
file logging (``console``), the event log (``events``), the Chrome trace
(``trace``), the counters (``counters``), round phase timing
(``timing``), the facade the engine holds (``core.Telemetry``), and the
readers the ledger record uses (``summary``, ``forensics``).  The
device-side numerics ring and the live monitor are not ported yet."""

from attackfl_tpu_torch.telemetry.console import Logger, print_with_color

__all__ = ["Logger", "print_with_color"]
