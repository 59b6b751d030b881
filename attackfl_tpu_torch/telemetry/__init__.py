"""Observability (the port's ``attackfl_tpu/telemetry``): console and
file logging (``console``), the event log (``events``), the Chrome trace
(``trace``), the counters (``counters``), round phase timing
(``timing``), the facade the engine holds (``core.Telemetry``), the
numerics ring's drainer and report (``numerics``; its device half is
``ops/metrics.py``), the live monitor (``monitor``), the readers the
``metrics`` command and the ledger record use (``summary``,
``forensics``), ``metrics --merge``'s interleaving of per-process and
spool event files with its round-skew report (``merge``), and the fleet
observatory over a run service's spool (``fleet``: ``fleet
report|trace``, ``/fleet`` and the SLO gauges)."""

from attackfl_tpu_torch.telemetry.console import Logger, print_with_color

__all__ = ["Logger", "print_with_color"]
