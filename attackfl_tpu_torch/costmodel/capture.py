"""Counted program profiles (the port's counterpart of
``attackfl_tpu/costmodel/capture.py``).

The JAX package asks XLA for a compiled program's ``cost_analysis`` and
``memory_analysis``.  The port has no compiled program to ask, so it
counts one dispatch of the program instead: :func:`count_program` runs
``fn`` under a counting ``TorchDispatchMode`` that sees every aten op
below autograd and ``vmap`` (the physical, batched shapes), passes each
through unchanged, and reads only its tensors' shapes, dtypes and strides,
never a value, so it adds no host sync and the results are the same bits.
Per op it counts

* **flops**: ``2·M·N·K`` for the matmul and convolution family (torch's
  own formulas, ``torch.utils.flop_counter``), one per output element for
  an elementwise op, one per input element for a reduction;
* **transcendentals**: the output elements of ``exp``, ``log``, ``tanh``,
  ``sigmoid``, ``erf``, ``pow``, ``rsqrt`` and the like;
* **bytes_accessed**: the bytes of the op's inputs and outputs, a
  broadcast (stride-0) dimension counted once; views count zero.

In eager PyTorch every op does read its operands from memory and write
its results back, so this count is the port's real traffic.  XLA's count
is taken after fusion, where intermediates stay in registers, so the two
packages' figures measure different things and need not agree.

The port's hand-written kernels are launched through ctypes, where no
dispatch mode sees them: their wrappers add their formula through
:func:`kernel_work` (``ops/fused_step.epoch_work`` for K1, ``mask_work``
for K3) and suspend the count inside, so a round's profile is the same
whether the kernel or its plain version runs.  Under ``FakeTensorMode``
(``cost estimate``'s count without a run) they return their outputs'
shapes without running.

``memory`` (on the card only; the CPU has no allocator to read, and the
profile is then partial, as JAX's guarded analysis degrades):
``argument`` and ``output`` are the bytes of the program's input and
result tensors, ``alias`` the results that are inputs updated in place,
``temp`` the allocator's peak during the dispatch less what was allocated
before it and less the outputs, and ``peak`` their sum, as JAX's.  The
peak is never reset (a caller may hold a reading of it): it is sampled
during the dispatch, and the allocator's own peak is taken when the
dispatch raised it.  The live allocation is read after every op whose fresh
outputs take 1 MiB or more (a read of the allocator's statistics costs
tens of microseconds, and the peak follows a large allocation).

The counter times its own bookkeeping (``overhead_s``, all of its host
time but the ops' own calls), which the engine takes out of the round's
spans (``Tracer.discount``): the counted dispatch's device work stays in
them, its bookkeeping does not.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode, _pop_mode_temporarily,
)

_aten = torch.ops.aten
# ops that move no data: metadata, aliases, fresh uninitialized storage
_FREE = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._unsafe_view, _aten.alias, _aten.detach,
    _aten.lift_fresh, _aten.promote_types, _aten.resize_, _aten.set_,
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel, _aten.is_contiguous,
})
# copies the op tags mark pointwise: no flops
_COPIES = frozenset({_aten.clone})
# a dispatch's live allocation is sampled after each op whose fresh
# outputs take at least this many bytes: the peak follows a large
# allocation, and one read of the allocator's statistics costs tens of us
_SAMPLE_BYTES = 1 << 20
# the reductions: one flop per input element (named here, as torch's op
# tags name them only in recent releases)
_REDUCTIONS = frozenset({
    _aten.all, _aten.amax, _aten.amin, _aten.aminmax, _aten.any, _aten.argmax,
    _aten.argmin, _aten.count_nonzero, _aten.linalg_vector_norm, _aten.logsumexp,
    _aten.max, _aten.mean, _aten.min, _aten.nansum, _aten.norm, _aten.prod, _aten.std,
    _aten.std_mean, _aten.sum, _aten.var, _aten.var_mean,
    _aten.cumsum, _aten.cumprod, _aten.sort, _aten.topk, _aten._softmax,
    _aten._log_softmax, _aten._softmax_backward_data,
    _aten._log_softmax_backward_data, _aten.native_layer_norm,
    _aten.native_layer_norm_backward, _aten.native_group_norm,
    _aten.native_group_norm_backward,
})
# elementwise ops: one flop per output element
_POINTWISE = getattr(torch.Tag, "pointwise", None)
_TRANSCENDENTAL = frozenset({
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log2, _aten.log10,
    _aten.log1p, _aten.tanh, _aten.sigmoid, _aten.erf, _aten.erfc,
    _aten.erfinv, _aten.pow, _aten.rsqrt, _aten.sqrt, _aten.sin, _aten.cos,
    _aten.tan, _aten.atan, _aten.atan2, _aten.sinh, _aten.cosh, _aten.gelu,
    _aten.gelu_backward, _aten.silu, _aten.softplus, _aten._softmax,
    _aten._log_softmax, _aten.logsumexp,
})

class _Stacks(threading.local):
    """This thread's open counts, as torch's dispatch-mode stack is this
    thread's: a run service's jobs count their programs from threads of
    one process, and a kernel launched in one must not add to another's
    count."""

    def __init__(self):
        # the counters counting now, innermost last
        self.active: list["ProgramCounter"] = []
        # the op_by_op() blocks open now
        self.op_by_op: list[bool] = []


_STACKS = _Stacks()


def counting() -> bool:
    """True inside a counted dispatch or an :func:`op_by_op` block: ops
    must dispatch one by one there to be seen, so a captured graph is not
    replayed there."""
    return bool(_STACKS.active or _STACKS.op_by_op)


@contextmanager
def op_by_op():
    """Run the programs called inside op by op, as a counted dispatch
    runs them (no captured graph's replay), for another dispatch mode that
    must see every op (the program audit's)."""
    _STACKS.op_by_op.append(True)
    try:
        yield
    finally:
        _STACKS.op_by_op.pop()


_FORMULAS: dict = {}


def _flop_formulas() -> dict:
    """torch's matmul and convolution flop formulas, imported on the
    first count."""
    if not _FORMULAS:
        from torch.utils.flop_counter import flop_registry

        _FORMULAS.update(flop_registry)
    return _FORMULAS


def _numel(t: torch.Tensor) -> int:
    """Elements a pass over ``t`` touches: a broadcast (stride-0)
    dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= int(size)
    return n


def _tensors(obj: Any) -> list[torch.Tensor]:
    """The tensors in ``obj``: nested dicts, lists, tuples and
    dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for item in obj for t in _tensors(item)]
    return []


def _nbytes(tensors: list[torch.Tensor]) -> int:
    """Bytes of ``tensors``, each storage once."""
    seen: dict[Any, int] = {}
    for t in tensors:
        key = (t.device, t.untyped_storage().data_ptr()) if t.device.type != "meta" \
            else id(t)
        seen[key] = max(seen.get(key, 0), t.numel() * t.element_size())
    return sum(seen.values())


def _allocated(device: torch.device) -> int:
    """The caching allocator's live bytes on ``device`` (host-side
    statistics: no sync)."""
    return torch.cuda.memory_stats_as_nested_dict(device)["allocated_bytes"]["all"]["current"]


def is_fake(t: Any) -> bool:
    """Whether ``t`` is a ``FakeTensorMode`` tensor: shapes only."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class ProgramCounter:
    """The running totals of one counted dispatch."""

    def __init__(self, device: torch.device | None = None):
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.paused = 0
        self.device = device if device is not None and device.type == "cuda" else None
        self.peak_sampled = 0
        self.overhead_s = 0.0

    def add(self, flops: int = 0, nbytes: int = 0, transcendentals: int = 0) -> None:
        self.flops += int(flops)
        self.bytes_accessed += int(nbytes)
        self.transcendentals += int(transcendentals)

    def count(self, func, args, kwargs, out) -> None:
        """One aten op's work (see the module doc); ``prim`` ops (a fake
        tensor's metadata queries) are none."""
        if func.namespace == "prim":
            return
        self.ops += 1
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return
        outs = _tensors(out)
        ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
        self.bytes_accessed += sum(_numel(t) * t.element_size() for t in ins + outs)
        if (self.device is not None and not func._schema.is_mutable
                and sum(t.numel() * t.element_size() for t in outs) >= _SAMPLE_BYTES):
            self.peak_sampled = max(self.peak_sampled, _allocated(self.device))
        formulas = _flop_formulas()
        if packet in formulas:
            self.flops += int(formulas[packet](*args, **kwargs, out_val=out))
        elif packet in _REDUCTIONS:
            self.flops += sum(_numel(t) for t in ins[:1])
        elif _POINTWISE in func.tags and packet not in _COPIES:
            self.flops += sum(_numel(t) for t in outs)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(_numel(t) for t in outs)


class _CountingMode(TorchDispatchMode):
    def __init__(self, counter: ProgramCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        t0 = time.perf_counter()
        kwargs = kwargs or {}
        t1 = time.perf_counter()
        out = func(*args, **kwargs)
        t2 = time.perf_counter()
        if not self.counter.paused:
            self.counter.count(func, args, kwargs, out)
        self.counter.overhead_s += (t1 - t0) + (time.perf_counter() - t2)
        return out


@contextmanager
def kernel_work(flops: int = 0, bytes: int = 0, transcendentals: int = 0):  # noqa: A002
    """A hand-written kernel's work by its formula: added to the
    innermost active counter, whose op count is suspended inside (the
    kernel's plain version runs aten ops the kernel does not): the
    counting mode steps off the dispatch stack, so they run at full
    speed.  Costs nothing when no program is being counted."""
    counter = _STACKS.active[-1] if _STACKS.active else None
    if counter is None:
        yield
        return
    counter.add(flops, bytes, transcendentals)
    counter.paused += 1
    try:
        if isinstance(_get_current_dispatch_mode(), _CountingMode):
            with _pop_mode_temporarily():
                yield
        else:
            yield
    finally:
        counter.paused -= 1


def warm() -> None:
    """Take the one-time set-up of torch's Python dispatch (about a second
    in a process's first dispatch mode) outside any counted dispatch."""
    with _CountingMode(ProgramCounter()):
        torch.zeros(1).add_(1)


def count_program(fn: Callable, *args, device: torch.device | str | None = None,
                  **kwargs) -> tuple[Any, dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under the counter: ``(result,
    profile)``, the profile with ``flops``, ``transcendentals``,
    ``bytes_accessed``, ``ops`` (the aten ops counted), ``count_ms`` (the
    host time of the counted dispatch), ``overhead_s`` (the counter's
    bookkeeping in it) and, on a CUDA ``device``, ``memory`` (see the
    module doc)."""
    device = torch.device(device) if device is not None else None
    counter = ProgramCounter(device)
    on_card = counter.device is not None
    if on_card:
        before = _allocated(device)
        peak_before = torch.cuda.max_memory_allocated(device)
        counter.peak_sampled = before
    _STACKS.active.append(counter)
    t0 = time.perf_counter()
    try:
        with _CountingMode(counter):
            result = fn(*args, **kwargs)
    finally:
        _STACKS.active.remove(counter)
    profile: dict[str, Any] = {
        "flops": counter.flops, "transcendentals": counter.transcendentals,
        "bytes_accessed": counter.bytes_accessed, "ops": counter.ops,
        "count_ms": round((time.perf_counter() - t0) * 1e3, 3)}
    if on_card:
        t1 = time.perf_counter()
    if on_card:
        peak_after = torch.cuda.max_memory_allocated(device)
        peak = max(counter.peak_sampled, peak_after if peak_after > peak_before else 0)
        inputs = _tensors((args, kwargs))
        in_ptrs = {t.untyped_storage().data_ptr() for t in inputs}
        outputs = _tensors(result)
        fresh = [t for t in outputs if t.untyped_storage().data_ptr() not in in_ptrs]
        aliased = [t for t in outputs if t.untyped_storage().data_ptr() in in_ptrs]
        memory = {"argument": _nbytes(inputs), "output": _nbytes(fresh),
                  "alias": _nbytes(aliased)}
        memory["temp"] = max(peak - before - memory["output"], 0)
        memory["peak"] = sum(memory[k] for k in ("argument", "output", "temp", "alias"))
        profile["memory"] = memory
        counter.overhead_s += time.perf_counter() - t1
    profile["overhead_s"] = counter.overhead_s
    return result, profile
