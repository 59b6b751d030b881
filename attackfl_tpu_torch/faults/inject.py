"""Fault injection (the port's ``attackfl_tpu/faults/inject.py``): the
device-side mask builder, the NaN storm, and the host-side injector.

Device side: :func:`build_client_fault_fn` resolves a plan's
``nan_storm`` or ``dropout`` specs once, when the round is built, into
two device tensors (each spec's fire round and its client mask) and
returns ``broadcast_number -> (C,) bool``: a compare and a reduction on
the device, with no device-to-host sync (JAX inject.py:248-277).

Host side: :class:`HostFaultInjector` is the one object the checkpoint
manager, the async writer's wiring and the round loop consult (JAX
inject.py:297-398).  It owns the consumable state (the remaining
``ckpt_write_error`` budgets, the fired-once latches).  Where the JAX
package emits a ``fault`` event, the port, which has no event log yet,
logs the same fields through its logger and keeps them in
:attr:`HostFaultInjector.records`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Sequence

import torch

from attackfl_tpu_torch.faults.plan import DEVICE_FAULT_KINDS, FaultSpec, device_specs
from attackfl_tpu_torch.ops.pytree import tree_map

log = logging.getLogger("attackfl_tpu_torch")


def build_client_fault_fn(plan: Sequence[FaultSpec], num_clients: int, kind: str,
                          device: str | torch.device = "cpu",
                          ) -> Callable[[int], torch.Tensor] | None:
    """``broadcast_number -> (C,) bool`` fire mask of one device-side
    kind, or None when the plan has none of it (the round then runs no
    injection op at all).  An empty cohort means every client; a client
    outside ``[0, num_clients)`` raises."""
    specs = device_specs(plan, kind)
    if not specs:
        return None
    rounds = torch.zeros(len(specs), dtype=torch.int64)
    masks = torch.zeros((len(specs), num_clients), dtype=torch.bool)
    for i, spec in enumerate(specs):
        rounds[i] = spec.round
        if spec.clients:
            for cid in spec.clients:
                if not 0 <= cid < num_clients:
                    raise ValueError(f"fault {kind}@{spec.round}: client {cid} out of "
                                     f"range [0, {num_clients})")
                masks[i, cid] = True
        else:
            masks[i, :] = True
    rounds, masks = rounds.to(device), masks.to(device)

    def fire_mask(broadcast_number: int) -> torch.Tensor:
        hit = rounds == broadcast_number                        # (k,)
        return torch.any(hit[:, None] & masks, dim=0)           # (C,)

    return fire_mask


def apply_nan_storm(storm: torch.Tensor, stacked: dict, ok: torch.Tensor
                    ) -> tuple[dict, torch.Tensor]:
    """The stormed clients' rows set to NaN in every floating leaf and
    their ok flags cleared: the failure a diverging client produces, so
    it takes the round's existing ok-flag path."""
    def poison(x):
        if not x.is_floating_point():
            return x
        sel = storm.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(sel, torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)

    return tree_map(poison, stacked), ok & ~storm


class HostFaultInjector:
    """Plan-driven host-side failures at the persistence seams.

    Each method is a no-op unless the plan armed its kind for the given
    round.  A firing happens once per (kind, round), except
    ``ckpt_write_error``, which fails ``count`` consecutive attempts at or
    after its round.  The async writer's thread calls the checkpoint
    seams; the round loop never calls them at the same time.
    ``monitor_stall`` and the service and scheduler kinds act on layers
    the port does not have, so nothing fires them, as in a JAX run
    without those layers (``maybe_stall_monitor`` returns on a missing
    monitor)."""

    def __init__(self, plan: Sequence[FaultSpec]):
        self._plan = tuple(plan)
        self._write_errors: dict[int, int] = {}
        for spec in self._plan:
            if spec.kind == "ckpt_write_error":
                self._write_errors[spec.round] = spec.count
        self._fired: set[tuple[str, int]] = set()
        self._device_noted: set[tuple[str, int]] = set()
        self.records: list[dict[str, Any]] = []

    def _specs(self, kind: str, round_no: int) -> list[FaultSpec]:
        return [s for s in self._plan if s.kind == kind and s.round == round_no]

    def _emit(self, kind: str, round_no: int, **details: Any) -> None:
        record = {"fault": kind, "action": "injected", "round": round_no, **details}
        self.records.append(record)
        log.warning("fault %s", json.dumps(record, sort_keys=True))

    def note_round_resolved(self, broadcast_number: int) -> None:
        """Record the device-side injections of a broadcast once its round
        has resolved (the injection itself ran in the round step)."""
        for kind in DEVICE_FAULT_KINDS:
            for spec in self._specs(kind, broadcast_number):
                key = (kind, broadcast_number)
                if key in self._device_noted:
                    continue
                self._device_noted.add(key)
                self._emit(kind, broadcast_number, clients=list(spec.clients),
                           device_side=True)

    def on_checkpoint_write(self, round_no: int) -> None:
        """At the top of every checkpoint write attempt: raises OSError
        while an armed ``ckpt_write_error`` budget at or before
        ``round_no`` lasts."""
        for armed_round, remaining in list(self._write_errors.items()):
            if round_no >= armed_round and remaining > 0:
                self._write_errors[armed_round] = remaining - 1
                self._emit("ckpt_write_error", round_no, remaining=remaining - 1)
                raise OSError(f"injected checkpoint write error (fault plan, round {round_no})")

    def after_checkpoint_write(self, round_no: int, entry_path: str) -> None:
        """After a round's entry is recorded: ``ckpt_torn`` truncates it to
        half its bytes; the manifest keeps the full hash, so a load
        rejects the entry and falls back."""
        for _spec in self._specs("ckpt_torn", round_no):
            key = ("ckpt_torn", round_no)
            if key in self._fired:
                continue
            self._fired.add(key)
            try:
                size = os.path.getsize(entry_path)
                with open(entry_path, "r+b") as fh:
                    fh.truncate(max(size // 2, 1))
            except OSError:
                continue
            self._emit("ckpt_torn", round_no, path=entry_path,
                       truncated_to=max(size // 2, 1), original_bytes=size)

    def maybe_kill_writer(self, round_no: int, writer) -> None:
        """``writer_death``: the async writer's thread exits before the
        round's submit (its supervisor restarts it on the next submit or
        drain)."""
        if writer is None:
            return
        for _spec in self._specs("writer_death", round_no):
            key = ("writer_death", round_no)
            if key in self._fired:
                continue
            self._fired.add(key)
            writer.inject_thread_death()
            self._emit("writer_death", round_no)
