"""Chrome-trace mining: ``torch.profiler`` traces -> op-level time
attribution (the port's copy of ``attackfl_tpu/profiler/mine.py``).

The torch-free half of the hotspot windows: the capture
(:mod:`attackfl_tpu_torch.profiler.capture`) exports each window as
``<telemetry dir>/profile/<host>.<pid>.<n>.<device>.trace.json.gz``; this
module parses it with stdlib gzip+json only.

**What a torch trace looks like**: ``traceEvents`` carries ``ph: "X"``
duration events in microseconds, each with a ``cat``.  A torch trace has
no ``hlo_op``/``hlo_module`` annotation, so the device rows and their
programs are read as follows:

* the device the run was on comes from the capture (the ``device``
  argument, or the ``.cuda``/``.cpu`` tag the capture writes into the
  file name), never from which rows happen to be present;
* on a CUDA run the device rows are the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` rows, their lane ``(pid, tid)`` the device and stream.
  A window with none of them is ``empty``: host rows never stand in;
* on a CPU run the device rows are the ``cpu_op`` rows (the CPU is the
  device there); nested rows get their self time as a fusion's
  constituents do;
* the profiler's own whole-window span (``cat: "Trace"``) and the
  ``cuda_runtime``/``cuda_driver`` rows are never device rows;
* a row's program is the innermost ``user_annotation`` span (the
  engine's ``record_function`` label around each dispatch) enclosing its
  launch on the host: a kernel row reaches its launch through
  ``args["correlation"]`` to the ``cuda_runtime``/``cuda_driver`` row of
  the same correlation.  The label is looked for on the launch's own
  thread, then on the process's other threads: autograd runs a backward
  pass on the card on a worker thread of its own while the labelled
  thread waits for it.  A row with no enclosing label is ``<unknown>``;
* a row's op is the innermost ``cpu_op`` (an ``aten::`` name) enclosing
  its launch, else a kernel's short name (template arguments and the
  parameter list stripped, namespace kept) or a copy's own name: the
  port's own kernels are launched through ctypes, outside any aten op.

**Attribution**: per (program, op) — total time (Σ dur), self time
(Σ dur minus nested children), share of the window's attributed self
time, and a category rollup (matmul / elementwise / reduction /
collective / copy / other).

**Dispatch-gap diagnosis**: merge every device-op interval into one
busy union; the gaps between consecutive busy stretches are time the
device sat idle waiting for the host to dispatch.  The gap histogram
(log-spaced buckets) plus ``host_bound_fraction`` = idle/span classify
each window device-bound vs host/dispatch-bound.

**Books-close invariant**::

    Σ op self-time <= device busy (per-lane interval union)
                   <= window wall x lanes

Torn / truncated / empty traces are COUNTED (status ``torn`` /
``empty``) and surfaced in every report — never silently dropped.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any

# Idle fraction of the window span past which a window is classified
# host/dispatch-bound rather than device-bound.
HOST_BOUND_THRESHOLD = 0.5
DEFAULT_TOP_K = 5
# Gap-histogram bucket upper edges (microseconds, log-spaced); the last
# bucket is open-ended (+inf).
GAP_BUCKETS_US = (10.0, 100.0, 1_000.0, 10_000.0, 100_000.0)
# Absolute float slop for the books-close comparisons (trace timestamps
# are microsecond floats; summing thousands of them wobbles).
_EPS_US = 1.0

TRACE_SUFFIX = ".trace.json.gz"


def _num(value: Any) -> float | None:
    """Bool-safe numeric coercion (``+ 0.0``, the costmodel idiom)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if value != value:  # NaN
        return None
    return value + 0.0


# ---------------------------------------------------------------------------
# op categories
# ---------------------------------------------------------------------------

# Whole-name substrings checked FIRST (collective names are hyphenated
# multi-token, so token sets would misfile all-reduce under reduction).
_COLLECTIVE_MARKS = ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective", "ppermute",
                     "partition-id", "replica-id", "nccl")
# JAX's HLO tokens, extended by the aten operators and the cuBLAS, cuDNN
# and CUTLASS kernel names of a torch trace
_MATMUL_TOKENS = frozenset({"dot", "convolution", "conv", "einsum",
                            "gemm", "cublas", "mm", "addmm", "bmm",
                            "baddbmm", "linear", "matmul", "cudnn",
                            "sgemm", "xmma", "cutlass", "wgmma"})
_REDUCTION_TOKENS = frozenset({"reduce", "sort", "topk", "argmax",
                               "argmin", "cumsum", "cumprod", "sum",
                               "mean", "norm", "amax", "amin",
                               "softmax", "std", "var"})
_ELEMENTWISE_TOKENS = frozenset({
    "add", "subtract", "multiply", "divide", "exp", "expm1", "log",
    "log1p", "tanh", "maximum", "minimum", "max", "min", "select",
    "compare", "rsqrt", "sqrt", "power", "abs", "negate", "sign",
    "clamp", "floor", "ceil", "round", "sigmoid", "logistic", "erf",
    "xor", "shift", "remainder", "atan2", "sin", "cos", "map",
    "mul", "sub", "div", "pow", "neg", "where", "gelu", "relu",
    "rshift", "lshift", "elementwise"})
_COPY_TOKENS = frozenset({
    "copy", "transpose", "reshape", "bitcast", "concatenate", "slice",
    "gather", "scatter", "dynamic", "update", "pad", "iota", "convert",
    "tuple", "parameter", "constant", "broadcast", "rng", "bitcast",
    "get", "while", "conditional", "call", "custom", "cat", "index",
    "memcpy", "memset", "fill", "clone", "stack"})
# whole operator names whose tokens would misfile them (aten's
# ``index_select`` is a gather, not an elementwise select), and the
# port's own kernels: K1 is one fused epoch whose time is its products,
# K3 fills dropout masks from a hash, as an RNG fill is a copy in JAX's
# table
_NAMED = {"index_select": "copy", "train_epoch_kernel": "matmul",
          "fill_masks": "copy"}


def _base_name(name: str) -> str:
    """``broadcast_divide_fusion.3`` -> ``broadcast_divide_fusion``
    (strip the trailing ``.N`` HLO instruction counter only)."""
    head, dot, tail = name.rpartition(".")
    if dot and tail.isdigit():
        return head
    return name


def kernel_short_name(name: str) -> str:
    """A CUDA kernel's name as the trace gives it, template arguments,
    parameter list and return type stripped, namespace kept:
    ``void at::native::reduce_kernel<512, 1>(...)`` ->
    ``at::native::reduce_kernel``; an anonymous namespace, as the port's
    kernels have, names nothing and goes."""
    out, depth = [], 0
    for ch in str(name).replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    text = "".join(out).split("(", 1)[0].strip()
    return text.split()[-1] if text else str(name)


def op_category(name: str) -> str:
    """Map one op, fusion or kernel name to its roofline category.
    Fusions keep their constituents' names (``broadcast_divide_fusion``),
    aten ops their namespace (``aten::mm``), so classification is
    token-based with a fixed priority: collective > matmul > reduction >
    elementwise > copy > other."""
    base = _base_name(str(name)).lower()
    if any(mark in base for mark in _COLLECTIVE_MARKS):
        return "collective"
    named = _NAMED.get(base.rpartition("::")[2])
    if named is not None:
        return named
    tokens = set(base.replace("::", "_").replace("-", "_")
                 .replace(" ", "_").split("_"))
    if tokens & _MATMUL_TOKENS:
        return "matmul"
    if tokens & _REDUCTION_TOKENS:
        return "reduction"
    if tokens & _ELEMENTWISE_TOKENS:
        return "elementwise"
    if tokens & _COPY_TOKENS:
        return "copy"
    return "other"


# ---------------------------------------------------------------------------
# trace loading
# ---------------------------------------------------------------------------

def load_trace_events(path: str) -> tuple[list[dict[str, Any]], str]:
    """One trace file -> (traceEvents, status).  ``status`` is ``ok``,
    ``empty`` (valid JSON, no events) or ``torn`` (truncated gzip,
    invalid JSON, unreadable file) — torn inputs return loudly, never
    raise."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as fh:
            raw = fh.read()
        doc = json.loads(raw.decode("utf-8"))
    except (OSError, EOFError, ValueError, UnicodeDecodeError):
        # gzip.BadGzipFile is an OSError; json errors are ValueError
        return [], "torn"
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return [], "torn"
    rows = [e for e in events if isinstance(e, dict)]
    return rows, ("ok" if rows else "empty")


DEVICES = ("cuda", "cpu")
# the device rows of a CUDA run, and the host rows that launch them
_CUDA_ROWS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
_LAUNCH_ROWS = frozenset({"cuda_runtime", "cuda_driver"})


def trace_device(path: str) -> str | None:
    """The device a trace's file name names (``<...>.cuda.trace.json.gz``),
    or None."""
    stem = os.path.basename(path)
    if stem.endswith(TRACE_SUFFIX):
        stem = stem[:-len(TRACE_SUFFIX)]
    tag = stem.rpartition(".")[2]
    return tag if tag in DEVICES else None


def _innermost(spans: list[tuple[float, float, str]],
               queries: list[tuple[float, int]]) -> dict[int, str]:
    """For each ``(time, key)`` query, the name of the innermost span of
    ``spans`` (``(start, end, name)`` on one host thread, nested as a
    thread's scopes are) that contains the time.  Keys with none are
    left out."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    found: dict[int, str] = {}
    stack: list[tuple[float, float, str]] = []
    i = 0
    for t, key in sorted(queries):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            found[key] = stack[-1][2]
    return found


def _device_ops(events: list[dict[str, Any]], device: str
                ) -> list[tuple[float, float, str, str, tuple]]:
    """The device rows of a torch trace on ``device`` (see the module
    doc), each with its program and op.  Returns (ts, dur, program,
    op_name, lane) rows."""
    host: dict[tuple, dict[str, list]] = {}
    launches: dict[Any, tuple[tuple, float]] = {}
    raw: list[tuple[float, float, str, tuple, Any]] = []
    for event in events:
        if event.get("ph") != "X":
            continue
        ts = _num(event.get("ts"))
        dur = _num(event.get("dur"))
        if ts is None or dur is None or dur < 0:
            continue
        cat = event.get("cat")
        lane = (event.get("pid"), event.get("tid"))
        name = str(event.get("name") or "<op>")
        args = event.get("args")
        args = args if isinstance(args, dict) else {}
        if cat in ("user_annotation", "cpu_op"):
            host.setdefault(lane, {"user_annotation": [], "cpu_op": []})[
                cat].append((ts, ts + dur, name))
        if device == "cpu":
            if cat == "cpu_op":
                raw.append((ts, dur, name, lane, (lane, ts + dur / 2)))
        elif cat in _LAUNCH_ROWS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (lane, ts + dur / 2)
        elif cat in _CUDA_ROWS:
            if cat == "kernel":
                name = kernel_short_name(name)
            raw.append((ts, dur, name, lane, args.get("correlation")))
    # where each row was launched: its own midpoint on a CPU run, its
    # launch row's on a CUDA run
    where: dict[int, tuple[tuple, float]] = {}
    for i, row in enumerate(raw):
        at = row[4] if device == "cpu" else launches.get(row[4])
        if at is not None:
            where[i] = at
    queries: dict[tuple, list[tuple[float, int]]] = {}
    for i, (lane, t) in where.items():
        queries.setdefault(lane, []).append((t, i))
    programs: dict[int, str] = {}
    aten_ops: dict[int, str] = {}
    for lane, items in queries.items():
        spans = host.get(lane)
        if spans is None:
            continue
        programs.update(_innermost(spans["user_annotation"], items))
        if device != "cpu":
            aten_ops.update(_innermost(spans["cpu_op"], items))
    # a launch on a thread with no label of its own: the labels of its
    # process's other threads
    labels: dict[Any, list] = {}
    for (pid, _), spans in host.items():
        labels.setdefault(pid, []).extend(spans["user_annotation"])
    orphans: dict[Any, list[tuple[float, int]]] = {}
    for lane, items in queries.items():
        orphans.setdefault(lane[0], []).extend(q for q in items if q[1] not in programs)
    for pid, items in orphans.items():
        if items and labels.get(pid):
            programs.update(_innermost(labels[pid], items))
    rows: list[tuple[float, float, str, str, tuple]] = []
    for i, (ts, dur, name, lane, _) in enumerate(raw):
        op = name if device == "cpu" else aten_ops.get(i, name)
        rows.append((ts, dur, programs.get(i, "<unknown>"), op, lane))
    return rows


# ---------------------------------------------------------------------------
# interval math
# ---------------------------------------------------------------------------

def _merge_intervals(intervals: list[tuple[float, float]]
                     ) -> list[tuple[float, float]]:
    if not intervals:
        return []
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def _self_durations(items: list[tuple[float, float]]) -> list[float]:
    """Per-event self time for one lane's (ts, dur) rows: dur minus the
    time covered by nested children (a fusion's span contains its
    constituents' spans on the same lane).  Items need not be sorted."""
    order = sorted(range(len(items)),
                   key=lambda i: (items[i][0], -items[i][1]))
    child_total = [0.0] * len(items)
    stack: list[int] = []  # indices of open (enclosing) events
    for i in order:
        ts, dur = items[i]
        end = ts + dur
        while stack and items[stack[-1]][0] + items[stack[-1]][1] \
                <= ts + 1e-9:
            stack.pop()
        if stack:
            # nested: this event's whole duration is the immediate
            # parent's child time (grandparents already count the parent)
            child_total[stack[-1]] += dur
        stack.append(i)
    return [max(items[i][1] - child_total[i], 0.0)
            for i in range(len(items))]


def _gap_histogram(union: list[tuple[float, float]]
                   ) -> tuple[list[dict[str, Any]], float]:
    """Gaps between consecutive busy stretches -> (histogram rows,
    total gap time).  Buckets are upper-edge labeled, last one +inf."""
    counts = [0] * (len(GAP_BUCKETS_US) + 1)
    total = 0.0
    for (_, prev_end), (next_start, _) in zip(union, union[1:]):
        gap = next_start - prev_end
        if gap <= 0:
            continue
        total += gap
        for b, edge in enumerate(GAP_BUCKETS_US):
            if gap <= edge:
                counts[b] += 1
                break
        else:
            counts[-1] += 1
    rows = [{"le_us": edge, "count": counts[b]}
            for b, edge in enumerate(GAP_BUCKETS_US)]
    rows.append({"le_us": None, "count": counts[-1]})
    return rows, total


# ---------------------------------------------------------------------------
# single-trace mining
# ---------------------------------------------------------------------------

def mine_trace(path: str, top_k: int = DEFAULT_TOP_K,
               device: str | None = None) -> dict[str, Any]:
    """One ``*.trace.json.gz`` -> the window's attribution report (see
    module doc for the fields).  ``device`` (``cuda`` or ``cpu``) is the
    run's device; by default the one the file name names, else ``cuda``,
    the port's default device.  Torn/empty traces come back with that
    status and zeroed attribution — counted by the caller, never
    dropped."""
    device = device or trace_device(path) or "cuda"
    events, status = load_trace_events(path)
    ops = _device_ops(events, device) if status == "ok" else []
    if status == "ok" and not ops:
        status = "empty"
    report: dict[str, Any] = {
        "trace": path, "device": device, "status": status, "lanes": 0,
        "wall_us": 0.0, "device_busy_us": 0.0, "op_self_us": 0.0,
        "host_bound_fraction": None, "classification": None,
        "gap_histogram": [], "ops": [], "top_ops": [],
        "categories": {}, "programs": {},
        "books": {"op_self_us": 0.0, "device_busy_us": 0.0,
                  "wall_us": 0.0, "lanes": 0, "close": status == "ok"},
    }
    if not ops:
        return report

    # per-lane rows for self time + busy union
    lanes: dict[tuple, list[int]] = {}
    for i, row in enumerate(ops):
        lanes.setdefault(row[4], []).append(i)
    self_us = [0.0] * len(ops)
    busy = 0.0
    for indices in lanes.values():
        items = [(ops[i][0], ops[i][1]) for i in indices]
        for i, self_dur in zip(indices, _self_durations(items)):
            self_us[i] = self_dur
        for start, end in _merge_intervals(
                [(ts, ts + dur) for ts, dur in items]):
            busy += end - start

    span_start = min(ts for ts, _, _, _, _ in ops)
    span_end = max(ts + dur for ts, dur, _, _, _ in ops)
    wall = max(span_end - span_start, 0.0)

    # dispatch-gap diagnosis over the cross-lane union: idle time is
    # host/dispatch time the device spent waiting
    union = _merge_intervals(
        [(ts, ts + dur) for ts, dur, _, _, _ in ops])
    histogram, gap_total = _gap_histogram(union)
    host_fraction = (gap_total / wall) if wall > 0 else 0.0

    # per-(program, op) attribution
    table: dict[tuple[str, str], dict[str, Any]] = {}
    for i, (_, dur, program, name, _) in enumerate(ops):
        key = (program, _base_name(name))
        row = table.setdefault(key, {
            "name": key[1], "program": program,
            "category": op_category(name),
            "count": 0, "total_us": 0.0, "self_us": 0.0})
        row["count"] += 1
        row["total_us"] += dur
        row["self_us"] += self_us[i]
    total_self = sum(row["self_us"] for row in table.values())
    rows = sorted(table.values(),
                  key=lambda r: (-r["self_us"], r["name"]))
    for row in rows:
        row["total_us"] = round(row["total_us"], 3)
        row["self_us"] = round(row["self_us"], 3)
        row["share"] = round(row["self_us"] / total_self, 4) \
            if total_self > 0 else 0.0

    categories: dict[str, dict[str, Any]] = {}
    for row in rows:
        bucket = categories.setdefault(
            row["category"], {"self_us": 0.0, "ops": 0})
        bucket["self_us"] = round(bucket["self_us"] + row["self_us"], 3)
        bucket["ops"] += 1
    for bucket in categories.values():
        bucket["share"] = round(bucket["self_us"] / total_self, 4) \
            if total_self > 0 else 0.0

    programs: dict[str, dict[str, Any]] = {}
    for row in rows:
        prog = programs.setdefault(
            row["program"], {"self_us": 0.0, "ops": 0, "top_op": None})
        prog["self_us"] = round(prog["self_us"] + row["self_us"], 3)
        prog["ops"] += 1
        if prog["top_op"] is None:  # rows arrive self-time sorted
            prog["top_op"] = row["name"]

    books_close = (total_self <= busy + _EPS_US
                   and busy <= wall * len(lanes) + _EPS_US)
    report.update({
        "lanes": len(lanes),
        "wall_us": round(wall, 3),
        "device_busy_us": round(busy, 3),
        "op_self_us": round(total_self, 3),
        "host_bound_fraction": round(host_fraction, 4),
        "classification": ("host_bound"
                           if host_fraction > HOST_BOUND_THRESHOLD
                           else "device_bound"),
        "gap_histogram": histogram,
        "ops": rows,
        "top_ops": rows[:max(int(top_k), 1)],
        "categories": categories,
        "programs": programs,
        "books": {"op_self_us": round(total_self, 3),
                  "device_busy_us": round(busy, 3),
                  "wall_us": round(wall, 3), "lanes": len(lanes),
                  "close": books_close},
    })
    return report


# ---------------------------------------------------------------------------
# directory mining (a run's whole profile/ tree)
# ---------------------------------------------------------------------------

def find_traces(profile_dir: str) -> list[str]:
    """Every ``*.trace.json.gz`` under ``profile_dir``, sorted for
    determinism."""
    found: list[str] = []
    for root, _, files in os.walk(profile_dir):
        for name in files:
            if name.endswith(TRACE_SUFFIX):
                found.append(os.path.join(root, name))
    return sorted(found)


def mine_profile_dir(profile_dir: str,
                     top_k: int = DEFAULT_TOP_K) -> dict[str, Any]:
    """Aggregate attribution over every trace window under a profile
    directory.  Torn/empty windows are counted in the header and listed
    in ``windows`` with their status — the books-close verdict is the
    conjunction over the OK windows only (a torn window has no books to
    close, but it is never hidden)."""
    paths = find_traces(profile_dir)
    windows = [mine_trace(path, top_k=top_k) for path in paths]
    ok = [w for w in windows if w["status"] == "ok"]
    torn = sum(1 for w in windows if w["status"] == "torn")
    empty = sum(1 for w in windows if w["status"] == "empty")

    table: dict[tuple[str, str], dict[str, Any]] = {}
    categories: dict[str, dict[str, Any]] = {}
    programs: dict[str, dict[str, Any]] = {}
    hist_counts: dict[Any, int] = {}
    wall = busy = total_self = 0.0
    gap_weight = 0.0
    for window in ok:
        wall += window["wall_us"]
        busy += window["device_busy_us"]
        total_self += window["op_self_us"]
        fraction = window["host_bound_fraction"] or 0.0
        gap_weight += fraction * window["wall_us"]
        for row in window["ops"]:
            key = (row["program"], row["name"])
            agg = table.setdefault(key, {
                "name": row["name"], "program": row["program"],
                "category": row["category"], "count": 0,
                "total_us": 0.0, "self_us": 0.0})
            agg["count"] += row["count"]
            agg["total_us"] = round(agg["total_us"] + row["total_us"], 3)
            agg["self_us"] = round(agg["self_us"] + row["self_us"], 3)
        for bucket in window["gap_histogram"]:
            hist_counts[bucket["le_us"]] = (
                hist_counts.get(bucket["le_us"], 0) + bucket["count"])

    rows = sorted(table.values(),
                  key=lambda r: (-r["self_us"], r["name"]))
    for row in rows:
        row["share"] = round(row["self_us"] / total_self, 4) \
            if total_self > 0 else 0.0
        bucket = categories.setdefault(
            row["category"], {"self_us": 0.0, "ops": 0})
        bucket["self_us"] = round(bucket["self_us"] + row["self_us"], 3)
        bucket["ops"] += 1
        prog = programs.setdefault(
            row["program"], {"self_us": 0.0, "ops": 0, "top_op": None})
        prog["self_us"] = round(prog["self_us"] + row["self_us"], 3)
        prog["ops"] += 1
        if prog["top_op"] is None:
            prog["top_op"] = row["name"]
    for bucket in categories.values():
        bucket["share"] = round(bucket["self_us"] / total_self, 4) \
            if total_self > 0 else 0.0

    host_fraction = (gap_weight / wall) if wall > 0 else None
    histogram = [{"le_us": edge, "count": hist_counts.get(edge, 0)}
                 for edge in (*GAP_BUCKETS_US, None)] if ok else []
    books_close = bool(ok) and all(w["books"]["close"] for w in ok)
    status = "ok" if ok else ("torn" if torn else
                              ("empty" if windows else "no_traces"))
    return {
        "dir": profile_dir,
        "traces": len(windows), "ok": len(ok),
        "torn": torn, "empty": empty,
        "status": status,
        "wall_us": round(wall, 3),
        "device_busy_us": round(busy, 3),
        "op_self_us": round(total_self, 3),
        "host_bound_fraction": (round(host_fraction, 4)
                                if host_fraction is not None else None),
        "classification": (
            ("host_bound" if host_fraction > HOST_BOUND_THRESHOLD
             else "device_bound") if host_fraction is not None else None),
        "gap_histogram": histogram,
        "ops": rows,
        "top_ops": rows[:max(int(top_k), 1)],
        "categories": categories,
        "programs": programs,
        "books": {"op_self_us": round(total_self, 3),
                  "device_busy_us": round(busy, 3),
                  "wall_us": round(wall, 3),
                  "close": books_close},
        "windows": [{"trace": os.path.basename(w["trace"]),
                     "status": w["status"], "wall_us": w["wall_us"],
                     "device_busy_us": w["device_busy_us"],
                     "host_bound_fraction": w["host_bound_fraction"],
                     "classification": w["classification"],
                     "books_close": w["books"]["close"]}
                    for w in windows],
    }


def compact_summary(report: dict[str, Any],
                    top_k: int = DEFAULT_TOP_K) -> dict[str, Any]:
    """The window fields a ``hotspot`` event (and the ledger block)
    carries: top-K ops, category shares, the diagnosis, the books."""
    out: dict[str, Any] = {
        "wall_us": report.get("wall_us"),
        "device_busy_us": report.get("device_busy_us"),
        "op_self_us": report.get("op_self_us"),
        "books_close": bool((report.get("books") or {}).get("close")),
        "top_ops": [
            {"name": row["name"], "program": row["program"],
             "category": row["category"], "self_us": row["self_us"],
             "share": row["share"]}
            for row in (report.get("top_ops") or [])[:top_k]],
        "category_shares": {
            name: bucket.get("share")
            for name, bucket in (report.get("categories") or {}).items()},
    }
    if report.get("host_bound_fraction") is not None:
        out["host_bound_fraction"] = report["host_bound_fraction"]
        out["classification"] = report.get("classification")
    if report.get("lanes"):
        out["lanes"] = report["lanes"]
    return out


# ---------------------------------------------------------------------------
# event-stream distillation (the ledger join's input)
# ---------------------------------------------------------------------------

def hotspots_from_events(events: list[dict[str, Any]]
                         ) -> dict[str, Any] | None:
    """One run's ``hotspot`` events -> the compact ledger block, or
    None when the run profiled nothing.  Window statuses are counted
    (unavailable/torn windows are part of the record), attribution is
    merged across OK windows, and the measured per-round device time —
    the number the cost-observatory join prices against — is
    Σ busy / Σ window rounds."""
    rows = [e for e in events if e.get("kind") == "hotspot"]
    if not rows:
        return None
    status_counts: dict[str, int] = {}
    for event in rows:
        status = str(event.get("status") or "unknown")
        status_counts[status] = status_counts.get(status, 0) + 1
    ok = [e for e in rows if e.get("status") == "ok"]

    wall = busy = gap_weight = 0.0
    rounds = 0
    ops: dict[tuple[str, str], dict[str, Any]] = {}
    cat_weight: dict[str, float] = {}
    books_close = bool(ok)
    for event in ok:
        w = _num(event.get("wall_us")) or 0.0
        b = _num(event.get("device_busy_us")) or 0.0
        wall += w
        busy += b
        fraction = _num(event.get("host_bound_fraction"))
        if fraction is not None:
            gap_weight += fraction * w
        first = event.get("round_first")
        last = event.get("round_last")
        if isinstance(first, int) and isinstance(last, int) \
                and not isinstance(first, bool) \
                and not isinstance(last, bool) and last >= first:
            rounds += last - first + 1
        if event.get("books_close") is False:
            books_close = False
        for row in event.get("top_ops") or []:
            if not isinstance(row, dict):
                continue
            key = (str(row.get("program") or ""),
                   str(row.get("name") or ""))
            agg = ops.setdefault(key, {
                "name": key[1], "program": key[0],
                "category": row.get("category"), "self_us": 0.0})
            agg["self_us"] = round(
                agg["self_us"] + (_num(row.get("self_us")) or 0.0), 3)
        shares = event.get("category_shares")
        if isinstance(shares, dict) and w > 0:
            for name, share in shares.items():
                value = _num(share)
                if value is not None:
                    cat_weight[str(name)] = (
                        cat_weight.get(str(name), 0.0) + value * w)

    top = sorted(ops.values(), key=lambda r: (-r["self_us"], r["name"]))
    top_total = sum(r["self_us"] for r in top)
    for row in top:
        row["share"] = round(row["self_us"] / top_total, 4) \
            if top_total > 0 else 0.0
    host_fraction = (gap_weight / wall) if wall > 0 else None
    block: dict[str, Any] = {
        "windows": len(rows),
        "status_counts": status_counts,
        "host_bound_fraction": (round(host_fraction, 4)
                                if host_fraction is not None else None),
        "classification": (
            ("host_bound" if host_fraction > HOST_BOUND_THRESHOLD
             else "device_bound") if host_fraction is not None else None),
        "device_busy_us": round(busy, 3),
        "wall_us": round(wall, 3),
        "books_close": books_close,
        "top_ops": top[:DEFAULT_TOP_K],
        "category_shares": {
            name: round(weight / wall, 4)
            for name, weight in sorted(cat_weight.items())} if wall > 0
        else {},
        "profiled_rounds": rounds,
        "measured_round_device_s": (
            round(busy / 1e6 / rounds, 6) if rounds > 0 and busy > 0
            else None),
    }
    return block
