"""Observability (the port's ``attackfl_tpu/telemetry``): console and
file logging (``console``), the event log (``events``), the Chrome trace
(``trace``), the counters (``counters``), round phase timing
(``timing``), the facade the engine holds (``core.Telemetry``), the
numerics ring's drainer and report (``numerics``; its device half is
``ops/metrics.py``), the live monitor (``monitor``), and the readers the
``metrics`` command and the ledger record use (``summary``,
``forensics``)."""

from attackfl_tpu_torch.telemetry.console import Logger, print_with_color

__all__ = ["Logger", "print_with_color"]
