"""Console and file logging (the port's ``attackfl_tpu/telemetry``: so
far its ``console`` module only; the event log is queue 1, item 16)."""

from attackfl_tpu_torch.telemetry.console import Logger, print_with_color

__all__ = ["Logger", "print_with_color"]
