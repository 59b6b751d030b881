"""Pure scheduling policy: priced tickets -> pack/preempt decisions (the
port's copy of ``attackfl_tpu/scheduler/policy.py``, whole).

No clocks of its own (``now`` is always passed in), no I/O, no torch —
every decision is a function of the tickets it is shown, so the policy
is unit-testable with a fake clock and the daemon-facing layer
(:mod:`.core`) stays a thin sync loop.

Priority + aging
----------------
Jobs carry a priority CLASS (``high``/``normal``/``low`` — base scores
100/50/10).  A queued ticket's effective priority ages linearly and
WITHOUT BOUND::

    effective = base + wait_seconds * aging_rate

Queued tickets are ordered by effective-priority BAND (``band_width``
points per band), then by predicted remaining device-seconds (shortest
first — the cost model's packing lever), then FIFO.  Unbounded aging is
what makes starvation impossible under sustained high-priority load:
after ``starvation_bound_seconds()`` of waiting, a low-priority ticket
outranks EVERY high-priority ticket submitted after it, so the work
ahead of it is finite and it eventually runs.  That outrank bound —
``(max_base - min_base + band_width) / aging_rate`` — is the number the
starvation-freedom test asserts.

Preemption
----------
Aging promotes queue ORDER only.  A running job is preempted solely for
a candidate of a strictly higher priority CLASS (base score, not aged
score — equals never thrash each other), and only after
``min_runtime_seconds`` of execution (anti-thrash guard).  Victims are
picked lowest class first, longest predicted remainder first — the
degradation ordering the overload policy documents.  The mechanics of
stopping (round-boundary stop hook, chunk-boundary checkpoint) belong
to the worker; the policy only names the victim.

Overload
--------
``backlog_seconds`` is the predicted device-seconds of all live work
divided by the slot count.  When a shed horizon is configured and
admitting one more job would push the backlog past it, the policy
prices the rejection: ``retry_after`` is how long the backlog needs to
drain back to the horizon at full throughput.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# priority classes: base effective-priority scores.  The spread between
# classes is what aging has to climb — see starvation_bound_seconds.
PRIORITY_CLASSES: dict[str, int] = {"high": 100, "normal": 50, "low": 10}
DEFAULT_PRIORITY = "normal"
# one band = how many effective-priority points "equal rank" spans; jobs
# inside a band are ordered by predicted cost (shortest first), so the
# cost model packs within a class while aging still promotes across
BAND_WIDTH = 10.0


def priority_base(name: str) -> int:
    """Class name -> base score; unknown names are an explicit error
    (a typo'd submission must not silently run at normal priority)."""
    try:
        return PRIORITY_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown priority {name!r}; choose from "
            f"{sorted(PRIORITY_CLASSES)}") from None


@dataclass
class Ticket:
    """One live job as the scheduler sees it: identity, price, state."""

    job_id: str
    priority: str = DEFAULT_PRIORITY
    predicted_seconds: float = 0.0
    pricing: dict[str, Any] = field(default_factory=dict)
    enqueued_ts: float = 0.0   # last transition into `queued` (monotonic)
    started_ts: float | None = None  # None while queued
    completed_fraction: float = 0.0
    preemptions: int = 0
    wait_seconds: float = 0.0  # accumulated across dispatches
    preempt_requested: bool = False
    seq: int = 0
    # fleet-trace identity: the causal id every schedule/slot
    # event names (stamped at submit, durable in the sealed spec), and
    # the tenant the job's device time bills to.  Pure pass-through for
    # the policy — decisions never read either.
    fleet_id: str = ""
    tenant: str = ""

    @property
    def base(self) -> int:
        return priority_base(self.priority)

    def remaining_seconds(self) -> float:
        done = min(max(self.completed_fraction, 0.0), 1.0)
        return max(self.predicted_seconds * (1.0 - done), 0.0)


@dataclass
class Plan:
    """One tick's decisions: tickets to start, tickets to preempt, and
    the backlog evidence every decision is judged against."""

    start: list[Ticket] = field(default_factory=list)
    preempt: list[Ticket] = field(default_factory=list)
    backlog_seconds: float = 0.0


class SchedulerPolicy:
    """The pure decision engine.  ``slots`` is the device budget in
    concurrent jobs (the old ``max_workers`` bound, now a packing target
    instead of a FIFO gate)."""

    def __init__(self, slots: int = 1, aging_rate: float = 1.0,
                 band_width: float = BAND_WIDTH,
                 min_runtime_seconds: float = 2.0,
                 shed_horizon_seconds: float = 0.0):
        self.slots = max(int(slots), 1)
        if aging_rate <= 0:
            raise ValueError(
                f"aging_rate must be > 0 (aging is the starvation-freedom "
                f"guarantee), got {aging_rate}")
        self.aging_rate = aging_rate
        self.band_width = max(float(band_width), 1e-9)
        self.min_runtime_seconds = max(float(min_runtime_seconds), 0.0)
        self.shed_horizon_seconds = max(float(shed_horizon_seconds), 0.0)

    # ---- effective priority -----------------------------------------

    def effective_priority(self, ticket: Ticket, now: float) -> float:
        wait = max(now - ticket.enqueued_ts, 0.0)
        return ticket.base + wait * self.aging_rate

    def _band(self, ticket: Ticket, now: float) -> int:
        return int(self.effective_priority(ticket, now) // self.band_width)

    def starvation_bound_seconds(self) -> float:
        """After this much queued wait, the LOWEST class strictly
        outranks (by band) any freshly submitted ticket of the HIGHEST
        class — the asserted aging bound."""
        bases = PRIORITY_CLASSES.values()
        return (max(bases) - min(bases) + self.band_width) / self.aging_rate

    # ---- packing + preemption ---------------------------------------

    def _queue_order(self, queued: list[Ticket], now: float) -> list[Ticket]:
        return sorted(
            queued,
            key=lambda t: (-self._band(t, now), t.remaining_seconds(),
                           t.enqueued_ts, t.seq, t.job_id))

    def plan(self, queued: list[Ticket], running: list[Ticket],
             now: float) -> Plan:
        plan = Plan()
        live = [t for t in queued + running]
        plan.backlog_seconds = round(
            sum(t.remaining_seconds() for t in live) / self.slots, 6)
        free = self.slots - len(running)
        # victims: strictly lower class first, longest remainder first
        # (the job that would hold its slot longest gives the backlog
        # the most relief per preemption)
        victims = sorted(
            (t for t in running if not t.preempt_requested),
            key=lambda t: (t.base, -t.remaining_seconds(), t.job_id))
        for ticket in self._queue_order(queued, now):
            if free > 0:
                plan.start.append(ticket)
                free -= 1
                continue
            victim = next(
                (v for v in victims
                 if v.base < ticket.base
                 and v.started_ts is not None
                 and now - v.started_ts >= self.min_runtime_seconds),
                None)
            if victim is None:
                continue  # keep scanning: a lower class may still fit later
            victim.preempt_requested = True
            victims.remove(victim)
            plan.preempt.append(victim)
            # the slot frees only when the victim reaches its safe seam
            # (round/chunk boundary) — the NEXT tick starts the candidate
        return plan

    # ---- overload ---------------------------------------------------

    def shed_decision(self, live: list[Ticket], candidate_seconds: float
                      ) -> dict[str, Any] | None:
        """None = admit.  Otherwise the priced rejection: the predicted
        backlog including the candidate exceeds the horizon, and
        ``retry_after_seconds`` is the drain time back to the horizon at
        full throughput."""
        if self.shed_horizon_seconds <= 0:
            return None
        backlog = (sum(t.remaining_seconds() for t in live)
                   + max(candidate_seconds, 0.0)) / self.slots
        if backlog <= self.shed_horizon_seconds:
            return None
        return {
            "backlog_seconds": round(backlog, 6),
            "horizon_seconds": self.shed_horizon_seconds,
            "retry_after_seconds": round(
                backlog - self.shed_horizon_seconds, 6),
        }
