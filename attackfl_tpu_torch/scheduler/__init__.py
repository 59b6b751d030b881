"""Preemptive multi-tenant device scheduler (the port's copy of
``attackfl_tpu/scheduler``).

* :mod:`.pricing` prices every job (run and matrix sweep) in predicted
  device-seconds through the cost model: the fingerprint peers' median
  first, the flops/bytes regression second, an explicit default for work
  it cannot predict;
* :mod:`.policy` makes the pure packing, preemption and aging decisions
  over priced tickets: priority classes with linear aging (the outrank
  bound is asserted in tests), cost-ordered packing within a band, and
  preemption only of strictly lower classes at the safe seams;
* :mod:`.core` is the daemon-facing :class:`~.core.JobScheduler`: it syncs
  tickets with the durable queue, trips the per-job circuit breaker, sheds
  load past the horizon and emits a ``schedule`` event for every decision.

Nothing here touches the card: decisions read ledger JSON and spool state.
"""

from attackfl_tpu_torch.scheduler.core import JobScheduler, OverloadShedError
from attackfl_tpu_torch.scheduler.policy import PRIORITY_CLASSES, SchedulerPolicy, Ticket
from attackfl_tpu_torch.scheduler.pricing import JobPricer

__all__ = [
    "JobScheduler", "OverloadShedError", "JobPricer",
    "PRIORITY_CLASSES", "SchedulerPolicy", "Ticket",
]
