"""Deterministic fault plans (the port's copy of
``attackfl_tpu/faults/plan.py:74-206``): what fails, when, and at whom.

A plan is a tuple of :class:`FaultSpec` entries on ``Config.faults`` (the
YAML ``faults:`` section or ``--inject-faults``).  Every spec is pinned
to a clock the simulation already carries: the broadcast counter for the
device-side kinds (it advances on retries, so a stormed broadcast fails
once and its retry runs clean) and the completed-round counter for the
host-side ones.  The same config and plan fail at the same points.

Device-side kinds (``faults/inject.build_client_fault_fn``, in the round
step): ``nan_storm`` sets the selected clients' rows to NaN and clears
their ok flags after the attack scatter; ``dropout`` forces the selected
clients to drop the broadcast (size 0, every sample masked).  Host-side
kinds (``faults/inject.HostFaultInjector``): ``ckpt_write_error``,
``ckpt_torn``, ``writer_death`` and ``monitor_stall``, and the run
service's and scheduler's kinds, on the service's own clocks:
``worker_death`` (a worker's completed rounds), ``queue_torn`` (the
queue's status-publish count), ``submit_flood`` (its submission count),
``preempt_storm`` (the scheduler's dispatch tick) and ``estimate_skew``
(the pricer's call count).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

DEVICE_FAULT_KINDS = ("nan_storm", "dropout")
HOST_FAULT_KINDS = (
    "ckpt_write_error", "ckpt_torn", "writer_death", "monitor_stall",
)
SERVICE_FAULT_KINDS = ("worker_death", "queue_torn", "submit_flood")
SCHEDULER_FAULT_KINDS = ("preempt_storm", "estimate_skew")
FAULT_KINDS = (DEVICE_FAULT_KINDS + HOST_FAULT_KINDS + SERVICE_FAULT_KINDS
               + SCHEDULER_FAULT_KINDS)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure.

    ``round`` is 1-based: the broadcast number for device-side kinds (the
    clock attacks already key on), the completed-round number for
    host-side kinds (the clock checkpoints key on), and the service's own
    deterministic counters for service-side kinds (a job's completed
    rounds for ``worker_death``, the n-th status publish for
    ``queue_torn``, the n-th submission for ``submit_flood``).
    ``clients`` selects the target cohort for device-side kinds (empty =
    every client); ``count`` is how many consecutive write attempts fail
    for ``ckpt_write_error``, how many duplicate submissions a
    ``submit_flood`` injects, how many running jobs a ``preempt_storm``
    force-preempts (scheduler tick clock), and the price multiplier an
    ``estimate_skew`` applies (pricing-call clock).
    """

    kind: str
    round: int
    clients: tuple[int, ...] = ()
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"Unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}")
        if self.round < 1:
            raise ValueError(
                f"fault round must be >= 1 (1-based clock), got {self.round}")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1, got {self.count}")
        if self.clients and self.kind not in DEVICE_FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} takes no client cohort")
        object.__setattr__(
            self, "clients", tuple(int(c) for c in self.clients))

    def describe(self) -> dict[str, Any]:
        """JSON-ready record for ``fault`` events / the run header."""
        out: dict[str, Any] = {"fault": self.kind, "round": self.round}
        if self.clients:
            out["clients"] = list(self.clients)
        if self.kind in ("ckpt_write_error", "submit_flood",
                         "preempt_storm", "estimate_skew"):
            out["count"] = self.count
        return out


def parse_fault_plan(spec: str) -> tuple[FaultSpec, ...]:
    """Parse the ``--inject-faults`` CLI grammar.

    ``kind@round[:key=value]...`` entries separated by ``;``, e.g.::

        nan_storm@3:clients=0,1;ckpt_write_error@2:count=2;writer_death@4

    ``clients`` is a comma-separated index list; unknown keys and
    malformed entries raise ``ValueError`` (a typo'd chaos plan must not
    silently run fault-free).
    """
    specs: list[FaultSpec] = []
    for raw_entry in spec.split(";"):
        entry = raw_entry.strip()
        if not entry:
            continue
        head, *opts = entry.split(":")
        kind, sep, round_text = head.partition("@")
        if not sep:
            raise ValueError(
                f"fault entry {entry!r} needs 'kind@round' (e.g. "
                "'nan_storm@3')")
        try:
            round_no = int(round_text)
        except ValueError:
            raise ValueError(
                f"fault entry {entry!r}: round {round_text!r} is not an "
                "integer") from None
        kwargs: dict[str, Any] = {}
        for opt in opts:
            key, sep, value = opt.partition("=")
            if not sep:
                raise ValueError(
                    f"fault entry {entry!r}: option {opt!r} needs key=value")
            key = key.strip()
            if key == "clients":
                kwargs["clients"] = tuple(
                    int(c) for c in value.split(",") if c.strip())
            elif key == "count":
                kwargs["count"] = int(value)
            else:
                raise ValueError(
                    f"fault entry {entry!r}: unknown option {key!r} "
                    "(have: clients, count)")
        specs.append(FaultSpec(kind=kind.strip(), round=round_no, **kwargs))
    return tuple(specs)


def faults_from_config(raw: Sequence[Any]) -> tuple[FaultSpec, ...]:
    """Build a plan from the YAML ``faults:`` section — a list of
    ``{kind, round, clients?, count?}`` mappings."""
    specs: list[FaultSpec] = []
    for item in raw or []:
        if not isinstance(item, dict):
            raise ValueError(
                f"faults: entries must be mappings, got {item!r}")
        unknown = set(item) - {"kind", "round", "clients", "count"}
        if unknown:
            raise ValueError(
                f"faults: entry has unknown key(s) {sorted(unknown)}")
        specs.append(FaultSpec(
            kind=str(item.get("kind", "")),
            round=int(item.get("round", 0)),
            clients=tuple(int(c) for c in item.get("clients", []) or []),
            count=int(item.get("count", 1)),
        ))
    return tuple(specs)


def device_specs(plan: Sequence[FaultSpec], kind: str) -> list[FaultSpec]:
    """The plan's entries of one device-side kind."""
    if kind not in DEVICE_FAULT_KINDS:
        raise ValueError(f"{kind!r} is not a device-side fault kind")
    return [s for s in plan if s.kind == kind]
