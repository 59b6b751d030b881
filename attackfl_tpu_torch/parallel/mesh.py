"""The client mesh: an ordered list of devices with an axis name, the
process that owns each, and the placement of stacked trees on it (the
port's ``attackfl_tpu/parallel/mesh.py``).

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

**Over more than one process** (JAX ``distributed_init``, the DCN mesh):
:func:`distributed_init` joins a ``torch.distributed`` process group,
after which :func:`make_client_mesh` spans every process's devices in rank
order, process 0's first, as ``jax.devices()`` lists them.  Every process
runs the same program SPMD on its own shards (:attr:`ClientMesh.
local_shards`) and holds the run's replicated state, from the shared seed,
on its own lead device.  The shards' blocks cross processes by one
function, :func:`exchange`: each tensor is copied to the host as bytes,
gathered by gloo's ``all_gather``, and copied back to this process's lead
device.  That is the only transport, not a fallback: gloo carries only
some collectives on CUDA tensors, and NCCL refuses two ranks on one GPU,
which is all one card can run.  Process 0's checkpoint bytes and the
run's telemetry id reach the other processes by :func:`broadcast_bytes`
and :func:`broadcast_string`, and a checkpoint is taken from
:func:`gather_to_host`.

JAX functions without a counterpart here: ``is_tpu_backend``,
``resolve_tpu_platform`` and ``shard_map_clients`` exist only for TPU
plugin names and jax version drift.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree

from attackfl_tpu_torch.ops import pytree as pt

# how long a process waits for its peers: joining the group, then each
# collective.  A missing peer fails the run after this, not a hang
# (JAX's jax.distributed.initialize waits 300 s for its coordinator)
DIST_TIMEOUT = datetime.timedelta(seconds=300)


def canonical(device: str | torch.device) -> torch.device:
    """``device`` with its index spelled out (``cuda`` is the current CUDA
    device), so that two spellings of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def distributed_init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the run's process group (JAX ``distributed_init``, the DCN
    scale-out entry point): every process runs the same SPMD program,
    and after this call :func:`make_client_mesh` spans every process's
    devices.  ``coordinator`` is process 0's ``host:port``; gloo over TCP
    carries the exchanges (module doc).  A peer that never comes fails
    the join after :data:`DIST_TIMEOUT`.  Typical invocation, one per
    host:

        python -m attackfl_tpu_torch run --config cfg.yaml \\
            --coordinator HOST0:1234 --num-processes 2 --process-id {0,1}
    """
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=DIST_TIMEOUT)


def process_count() -> int:
    """The processes of the run's group (1 without one), ``jax.process_count``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one), ``jax.process_index``."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh: ``devices`` in shard order (shard 0 first), of one
    device type, a device possibly repeated; ``processes`` the process
    that owns each shard (all 0 by default), in rank order, each owning
    as many shards; ``process_index`` the process this mesh object lives
    in, which runs its shards (:attr:`local_shards`)."""

    devices: tuple[torch.device, ...]
    axis_name: str = "clients"
    processes: tuple[int, ...] = ()
    process_index: int = 0

    def __post_init__(self):
        devices = tuple(canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, not {devices}")
        processes = tuple(self.processes) or (0,) * len(devices)
        if len(processes) != len(devices) or list(processes) != sorted(processes):
            raise ValueError(f"processes {processes} must name each of {len(devices)} shards' "
                             "owner, in rank order")
        if len({processes.count(p) for p in processes}) != 1:
            raise ValueError(f"every process owns as many shards, not {processes}")
        if self.process_index not in processes:
            raise ValueError(f"process {self.process_index} owns no shard of {processes}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "processes", processes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_shards(self) -> tuple[int, ...]:
        """The shards this process runs, in shard order."""
        return tuple(i for i, p in enumerate(self.processes) if p == self.process_index)

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        return tuple(self.devices[i] for i in self.local_shards)

    @property
    def lead(self) -> torch.device:
        """This process's first shard's device (shard 0's in one process),
        where the run's state and every replicated result live."""
        return self.devices[self.local_shards[0]]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """This process's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.local_devices))

    def blocks(self, n: int) -> list[slice]:
        """The rows of each shard's contiguous block of an ``n``-row
        leading axis; ``n`` must divide by the mesh size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} shards")
        per = n // self.size
        return [slice(i * per, (i + 1) * per) for i in range(self.size)]


def is_multiprocess(mesh: ClientMesh | None) -> bool:
    """True when ``mesh``'s shards belong to more than one process: every
    process then runs its own shards and the blocks cross processes."""
    return mesh is not None and len(set(mesh.processes)) > 1


def make_client_mesh(num_devices: int = 0, axis_name: str = "clients",
                     device: str | torch.device = "cuda",
                     devices=None) -> ClientMesh:
    """A mesh over the first ``num_devices`` visible devices of
    ``device``'s type (0: all of them; more than are visible: all of them,
    as JAX truncates), ``device`` itself first, as the lead.  The CPU
    gives one device.  ``devices``, a list in which a device may repeat,
    builds the mesh over exactly those instead (the tests' many shards of
    one device).  After :func:`distributed_init` the mesh spans every
    process's devices so chosen, in rank order; a nonzero
    ``num_devices`` is then refused, as JAX refuses it."""
    count = process_count()
    if count > 1 and num_devices and num_devices > 0:
        # truncating would leave some processes without a shard
        raise ValueError("mesh.num-devices is a single-host knob; multi-host runs "
                         "use every process's devices (set num-devices: 0)")
    if devices is not None:
        local = [torch.device(d) for d in devices]
    else:
        dev = torch.device(device)
        if dev.type == "cpu":
            local = [dev]
        elif dev.type != "cuda":
            raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
        else:
            visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not visible:
                raise RuntimeError("no CUDA device is visible for the client mesh")
            lead = canonical(dev)
            local = [lead] + [d for d in visible if d != lead]
            if num_devices and num_devices > 0:
                local = local[:num_devices]
    if count == 1:
        return ClientMesh(tuple(local), axis_name)
    spans: list = [None] * count
    dist.all_gather_object(spans, [str(canonical(d)) for d in local])
    return ClientMesh(tuple(torch.device(d) for span in spans for d in span), axis_name,
                      tuple(rank for rank, span in enumerate(spans) for _ in span),
                      process_index())


# ---------------------------------------------------------------------------
# the transport between processes
# ---------------------------------------------------------------------------

def _packed(tree: Any) -> tuple[torch.Tensor, list, Any]:
    leaves, spec = _pytree.tree_flatten(tree)
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError("exchange carries trees of tensors only")
    metas = [(x.dtype, tuple(x.shape)) for x in leaves]
    data = [x.detach().cpu().contiguous().reshape(-1).view(torch.uint8) for x in leaves]
    return (torch.cat(data) if data else torch.zeros(0, dtype=torch.uint8)), metas, spec


def _unpacked(data: torch.Tensor, metas: list, spec: Any, device: torch.device) -> Any:
    leaves, offset = [], 0
    for dtype, shape in metas:
        size = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        leaves.append(data[offset:offset + size].clone().view(dtype).reshape(shape)
                      .to(device))
        offset += size
    return _pytree.tree_unflatten(leaves, spec)


def exchange(local: Sequence[Any], mesh: ClientMesh) -> list:
    """Every shard's tree from each process's own: ``local`` holds one
    tree of tensors per local shard (of the same structure, shapes and
    dtypes on every shard of the mesh), the result one per shard, in
    shard order; the local shards' are ``local``'s own, the others' on
    this process's lead device.  In one process it is ``local``.

    The port's one transport between processes (module doc): each
    shard's tensors as bytes on the host, one gloo ``all_gather`` of the
    process's shards, and copies back to the lead device.  Bytes cross
    unchanged, whatever the dtype, so every process holds the same bits.
    A collective: every process calls it in the same order."""
    local = list(local)
    if len(local) != len(mesh.local_shards):
        raise ValueError(f"{len(local)} trees for {len(mesh.local_shards)} local shards")
    if not is_multiprocess(mesh):
        return local
    packed = [_packed(tree) for tree in local]
    mine = torch.stack([data for data, _, _ in packed])
    gathered = [torch.empty_like(mine) for _ in range(len(set(mesh.processes)))]
    dist.all_gather(gathered, mine)
    _, metas, spec = packed[0]
    out, seen = [], {}
    for shard, owner in enumerate(mesh.processes):
        j = seen.get(owner, 0)
        seen[owner] = j + 1
        out.append(local[j] if owner == mesh.process_index
                   else _unpacked(gathered[owner][j], metas, spec, mesh.lead))
    return out


def broadcast_bytes(data: bytes | None) -> bytes | None:
    """Process 0's byte string on every process (None if process 0 has
    none), JAX's wire contract: first the length as an int64 (-1 for
    None), then the bytes as a uint8 tensor from rank 0.  Lets every
    process restore the same checkpoint when only process 0 can read it.
    A collective."""
    length = torch.tensor([len(data) if data is not None else -1], dtype=torch.int64)
    dist.broadcast(length, src=0)
    n = int(length)
    if n <= 0:
        return None if n < 0 else b""
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
           if data is not None and len(data) == n else torch.zeros(n, dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return buf.numpy().tobytes()


def broadcast_string(text: str | None) -> str | None:
    """Process 0's UTF-8 string on every process (None passes through):
    the shared telemetry ``run_id`` that ``metrics --merge`` correlates
    the per-process event files by.  A collective."""
    data = broadcast_bytes(text.encode("utf-8") if text is not None else None)
    return data.decode("utf-8") if data is not None else None


def replicate_to_mesh(tree: Any, mesh: ClientMesh) -> Any:
    """A tree of this process's values in the mesh's replicated
    placement: every tensor on this process's lead device, from which
    the round's programs copy it to the local shards.  Every process
    holds the same values (the same seed gives the same init, or the same
    broadcast bytes), as JAX assumes of ``replicate_to_mesh``."""
    def put(x):
        return x.to(mesh.lead) if isinstance(x, torch.Tensor) else x
    return _pytree.tree_map(put, tree)


def gather_to_host(tree: Any, mesh: ClientMesh) -> Any:
    """The whole tree as host tensors on every process, from one
    all_gather of every process's copy (the gather half of a checkpoint
    over more than one process).  Each process holds the whole tree
    (:func:`gather_stacked` brought every shard's block to it), so the
    gather takes process 0's copy on every process, and raises on every
    process if another process's copy differs: the processes ran apart,
    and no process's state is the run's.  Non-tensor leaves stay as
    they are; in one process it is a copy to the host."""
    leaves, spec = _pytree.tree_flatten(tree)
    slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    tensors = [leaves[i].detach().cpu() for i in slots]
    if is_multiprocess(mesh):
        data, metas, inner = _packed(tensors)
        copies = [torch.empty_like(data) for _ in range(len(set(mesh.processes)))]
        dist.all_gather(copies, data)
        apart = [p for p, copy in enumerate(copies) if not torch.equal(copy, copies[0])]
        if apart:
            raise RuntimeError(f"processes {apart} hold another state than process 0's: "
                               "the SPMD run has diverged")
        tensors = _unpacked(copies[0], metas, inner, torch.device("cpu"))
    for i, x in zip(slots, tensors):
        leaves[i] = x
    return _pytree.tree_unflatten(leaves, spec)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

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
    """One tree per local shard: every tensor leaf's leading axis cut
    into the mesh's contiguous blocks (:meth:`ClientMesh.blocks`), shard
    ``i``'s block on its device; 0-dim leaves and non-tensors go to every
    shard as they are.  Used for the client axis of a round and for the
    scenario matrix's cell axis."""
    axis = axis_name or mesh.axis_name
    out = []
    for i in mesh.local_shards:
        device = mesh.devices[i]

        def put(x, i=i, device=device):
            dim = _split_dim(x, axis)
            if dim is None:
                return x
            return x.narrow(dim, mesh.blocks(x.shape[dim])[i].start,
                            x.shape[dim] // mesh.size).to(device)
        out.append(pt.tree_map(put, tree) if isinstance(tree, dict) else put(tree))
    return out


def replicate_local(tree: Any, mesh: ClientMesh) -> list:
    """One copy of ``tree`` per local shard, on its device: a copy
    between devices, the tree itself on a repeated one."""
    def put(x, device):
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return [pt.tree_map(lambda x, d=device: put(x, d), tree) if isinstance(tree, dict)
            else put(tree, device) for device in mesh.local_devices]


def gather_stacked(blocks: list, mesh: ClientMesh) -> Any:
    """The inverse of :func:`shard_stacked` for stacked leaves: the local
    shards' blocks (trees of tensors: a dict, a tuple, a tensor) and,
    over more than one process, the other processes' by
    :func:`exchange`, concatenated leaf by leaf in shard order on the
    lead device.  A one-shard mesh returns its block as it is."""
    if mesh.size == 1:
        return blocks[0]
    flat = [_pytree.tree_flatten(b) for b in exchange(blocks, mesh)]
    leaves = [torch.cat([f[0][k].to(mesh.lead) for f in flat]) for k in range(len(flat[0][0]))]
    return _pytree.tree_unflatten(leaves, flat[0][1])


@dataclass(frozen=True)
class Sharding:
    """A placement on a mesh: the leading axis split over ``axis_name``,
    or replicated on every shard when it is None (JAX's
    ``NamedSharding(mesh, P(axis))`` and ``NamedSharding(mesh, P())``)."""

    mesh: ClientMesh
    axis_name: str | None

    def place(self, tree: Any) -> list:
        """``tree`` placed: one tree per local shard."""
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
