"""The client mesh of one process: an ordered list of devices with an axis
name, and the placement of stacked trees on it (the single-process half of
``attackfl_tpu/parallel/mesh.py``).

JAX declares placement with ``NamedSharding`` and lets XLA's partitioner
insert the communication.  Torch has no partitioner, so the port's mesh is
explicit: :class:`ClientMesh` holds the devices in shard order, and the
helpers here split a stacked tree's leading (client) axis into one
contiguous block per shard (:func:`shard_stacked`), copy a tree to every
shard (:func:`replicate_local`) and put the blocks back on the lead device
(:func:`gather_stacked`).  The collectives that a sharded aggregation runs
between the shards are in :mod:`attackfl_tpu_torch.parallel.shard`.

A device may repeat in a mesh (``make_client_mesh(devices=[...])``): that
is the port's counterpart of JAX's virtual CPU devices.  The CPU tests
build 8 shards of ``cpu`` and the card's smoke test 2 shards of
``cuda:0``; a copy between two shards of one device is a no-op, so such a
mesh runs every per-shard program and every collective of a real one
without moving a byte.

JAX functions without a counterpart here: ``is_tpu_backend``,
``resolve_tpu_platform`` and ``shard_map_clients`` exist only for TPU
plugin names and jax version drift.  The multi-process functions
(``distributed_init``, ``is_multiprocess``, ``replicate_to_mesh``,
``gather_to_host``, ``broadcast_bytes``, ``broadcast_string``) are ROADMAP
item 14b and not written: a mesh here never spans processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from attackfl_tpu_torch.ops import pytree as pt


def canonical(device: str | torch.device) -> torch.device:
    """``device`` with its index spelled out (``cuda`` is the current CUDA
    device), so that two spellings of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh: ``devices`` in shard order (shard 0, the lead, first),
    of one device type; a device may repeat."""

    devices: tuple[torch.device, ...]
    axis_name: str = "clients"

    def __post_init__(self):
        devices = tuple(canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, not {devices}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Shard 0's device, where the run's state and every replicated
        result live."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def blocks(self, n: int) -> list[slice]:
        """The rows of each shard's contiguous block of an ``n``-row
        leading axis; ``n`` must divide by the mesh size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} shards")
        per = n // self.size
        return [slice(i * per, (i + 1) * per) for i in range(self.size)]


def make_client_mesh(num_devices: int = 0, axis_name: str = "clients",
                     device: str | torch.device = "cuda",
                     devices=None) -> ClientMesh:
    """A mesh over the first ``num_devices`` visible devices of
    ``device``'s type (0: all of them; more than are visible: all of them,
    as JAX truncates), ``device`` itself first, as the lead.  The CPU
    gives one device.  ``devices``, a list in which a device may repeat,
    builds the mesh over exactly those instead (the tests' many shards of
    one device)."""
    if devices is not None:
        return ClientMesh(tuple(torch.device(d) for d in devices), axis_name)
    dev = torch.device(device)
    if dev.type == "cpu":
        return ClientMesh((dev,), axis_name)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not visible:
        raise RuntimeError("no CUDA device is visible for the client mesh")
    lead = canonical(dev)
    visible = [lead] + [d for d in visible if d != lead]
    if num_devices and num_devices > 0:
        visible = visible[:num_devices]
    return ClientMesh(tuple(visible), axis_name)


def leading_axis_spec(x, axis_name: str = "clients") -> tuple:
    """The placement of a stacked leaf, one entry per dimension: the
    leading axis on the mesh axis, every other dimension unsplit (None),
    as JAX's rank-aware PartitionSpec spells it."""
    ndim = getattr(x, "ndim", 1)
    return (axis_name,) + (None,) * (max(ndim, 1) - 1)


def _split_dim(x, axis_name: str) -> int | None:
    """The dimension :func:`leading_axis_spec` puts on ``axis_name``, or
    None for a leaf that is not split (not a tensor, or 0-dim)."""
    if not isinstance(x, torch.Tensor) or x.ndim < 1:
        return None
    return leading_axis_spec(x, axis_name).index(axis_name)


def shard_stacked(tree: Any, mesh: ClientMesh, axis_name: str | None = None) -> list:
    """One tree per shard: every tensor leaf's leading axis cut into the
    mesh's contiguous blocks (:meth:`ClientMesh.blocks`), block ``i`` on
    shard ``i``'s device; 0-dim leaves and non-tensors go to every shard
    as they are.  Used for the client axis of a round and for the
    scenario matrix's cell axis."""
    axis = axis_name or mesh.axis_name
    out = []
    for i, device in enumerate(mesh.devices):
        def put(x, i=i, device=device):
            dim = _split_dim(x, axis)
            if dim is None:
                return x
            return x.narrow(dim, mesh.blocks(x.shape[dim])[i].start,
                            x.shape[dim] // mesh.size).to(device)
        out.append(pt.tree_map(put, tree) if isinstance(tree, dict) else put(tree))
    return out


def replicate_local(tree: Any, mesh: ClientMesh) -> list:
    """One copy of ``tree`` per shard, on its device: a copy between
    devices, the tree itself on a repeated one."""
    def put(x, device):
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return [pt.tree_map(lambda x, d=device: put(x, d), tree) if isinstance(tree, dict)
            else put(tree, device) for device in mesh.devices]


def gather_stacked(blocks: list, mesh: ClientMesh) -> Any:
    """The inverse of :func:`shard_stacked` for stacked leaves: the
    shards' blocks concatenated in shard order on the lead device.  A
    one-shard mesh returns its block as it is."""
    if mesh.size == 1:
        return blocks[0]

    def cat(*xs):
        return torch.cat([x.to(mesh.lead) for x in xs])
    return pt.tree_map(cat, *blocks) if isinstance(blocks[0], dict) else cat(*blocks)


@dataclass(frozen=True)
class Sharding:
    """A placement on a mesh: the leading axis split over ``axis_name``,
    or replicated on every shard when it is None (JAX's
    ``NamedSharding(mesh, P(axis))`` and ``NamedSharding(mesh, P())``)."""

    mesh: ClientMesh
    axis_name: str | None

    def place(self, tree: Any) -> list:
        """``tree`` placed: one tree per shard."""
        if self.axis_name is None:
            return replicate_local(tree, self.mesh)
        return shard_stacked(tree, self.mesh, self.axis_name)


def client_sharding(mesh: ClientMesh, axis_name: str | None = None) -> Sharding:
    """The placement that splits the leading (client) axis over the mesh."""
    return Sharding(mesh, axis_name or mesh.axis_name)


def replicate(mesh: ClientMesh) -> Sharding:
    return Sharding(mesh, None)


def make_constrain(mesh: ClientMesh | None, axis_name: str = "clients") -> Callable:
    """The function that pins a stacked tree to its canonical layout
    between the round's halves (identity without a mesh).  JAX pins the
    leading axis to the mesh inside the program; the port, whose
    per-shard programs take their blocks from :func:`shard_stacked`,
    keeps a stacked tree gathered on the lead device between them, so
    this puts every tensor leaf there (a no-op for a leaf already
    there)."""
    if mesh is None:
        return lambda tree: tree

    def constrain_leaf(x):
        return x.to(mesh.lead) if isinstance(x, torch.Tensor) else x

    def constrain(tree):
        return (pt.tree_map(constrain_leaf, tree) if isinstance(tree, dict)
                else constrain_leaf(tree))

    return constrain


def build_per_device(mesh: ClientMesh, build: Callable[[torch.device], Any],
                     lead: Any = None) -> dict[torch.device, Any]:
    """``build(device)`` once for each distinct device of the mesh, by
    device; ``lead``, when given, stands for the lead device's (a program
    built already on the run's device)."""
    out = {}
    for device in mesh.distinct:
        out[device] = lead if (device == mesh.lead and lead is not None) else build(device)
    return out
