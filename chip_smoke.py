#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (attackfl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):
  1. device   -- the card's name and power limit, torch and CUDA versions;
  2. build    -- compile every CUDA kernel from csrc/ with nvcc (sm_90a);
  3. kernels  -- each kernel against its plain PyTorch version on the same
                 inputs at the main path's shapes, with the stated
                 tolerances, and its time beside its roofline bound;
  4. main     -- the port's Simulator on the card with BASELINE config 4
                 (ICU TransformerModel, 100 clients, 25 LIE attackers,
                 fedavg, local_backend pallas), cut in depth only, and
                 the kernels' launch counts over that run.
The second-to-last line is the kernels JSON record, the last line
``{"ok": true, "device": {...}}``.  It needs one CUDA device and the CUDA
toolkit, imports nothing of JAX, and fails when run outside the repository.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attackfl_tpu_torch.config import Config  # noqa: E402
from attackfl_tpu_torch.data.synthetic import get_dataset  # noqa: E402
from attackfl_tpu_torch.device import resolve_device  # noqa: E402
from attackfl_tpu_torch.models.icu import TransformerModel  # noqa: E402
from attackfl_tpu_torch.ops import build  # noqa: E402
from attackfl_tpu_torch.ops import fused_step as tfs  # noqa: E402
from attackfl_tpu_torch.ops.pytree import tree_leaves, tree_map  # noqa: E402
from attackfl_tpu_torch.profile_round import CONFIG4, DEPTH  # noqa: E402
from attackfl_tpu_torch.training.engine import Simulator  # noqa: E402

# BASELINE config 4 is cut in depth only (width, clients, attackers and
# batch stay as published): epochs and samples per client to DEPTH["cut"],
# rounds from 30 to 3
ROUNDS = (30, 3)

# published peaks of the H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM bandwidth
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12

# kernel vs plain version: p absolute, loss absolute per step, m and v
# each relative to the largest magnitude of the plain version's tensor
PARAM_TOL, LOSS_TOL_PER_STEP, MV_RTOL = 2e-4, 1e-4, 1e-3
# from the cold Adam state p is gated where the first step's gradient is
# at least this large (Adam's eps is 1e-8); see check_fused_step
GRAD_FLOOR = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_card(card: str) -> None:
    """The bound uses the H100 SXM's peaks; refuse any other card."""
    name = card.split(",")[0]
    if "H100" not in name or "HBM3" not in name:
        raise RuntimeError(f"no peak rates for {name!r}: the bound assumes an H100 SXM")


def time_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernel_inputs(C: int, nb: int, B: int, masked_client: int):
    """Seeded config-4 step inputs: the port's init nudged per client, and
    minibatches gathered from the synthetic ICU train set with the padded
    tails of clients of U[lo, hi] samples (the cut depth) masked.  Also
    returns the packed layout's live mask (1 on parameters, 0 on padding)."""
    rng = np.random.default_rng(0)
    params = TransformerModel().init(torch.Generator().manual_seed(0))
    noise = torch.Generator().manual_seed(1)
    stacked = tree_map(lambda x: (x.expand((C,) + tuple(x.shape)) + 0.01 * torch.randn(
        (C,) + tuple(x.shape), generator=noise)).contiguous(), params)
    data = get_dataset("ICU", "train", CONFIG4["train_size"], CONFIG4["random_seed"])
    feats = np.concatenate([data["vitals"], data["labs"], data["label"][:, None]], 1)
    idx = rng.integers(0, feats.shape[0], (C, nb * B))
    lo, hi = DEPTH["cut"]["num_data_range"]
    sizes = rng.integers(lo, hi + 1, C)
    mask = (np.arange(nb * B)[None] < sizes[:, None]).astype(np.float32)
    mask[masked_client] = 0.0
    batches = np.zeros((C, nb, B, 32), np.float32)
    batches[..., :24] = feats[idx].reshape(C, nb, B, 24)
    batches[..., 24] = mask.reshape(C, nb, B)
    groups = tfs.pack_params(tree_map(lambda x: x.cuda(), stacked))
    live = tfs.pack_params(tree_map(lambda x: torch.ones_like(x).cuda(), stacked))
    return groups, torch.from_numpy(batches).cuda(), live


def warm_state(live, masked_client: int):
    """A seeded mid-training Adam state (|m| ~ 1e-3, v in [1e-7, 1.1e-6])
    on the live entries.  Padding, and the fully masked client, keep
    m = v = 0, as in training, so their steps are exact no-ops."""
    g = torch.Generator(device="cuda").manual_seed(3)
    m = {k: 1e-3 * torch.randn(x.shape, generator=g, device="cuda") * x
         for k, x in live.items()}
    v = {k: (1e-7 + 1e-6 * torch.rand(x.shape, generator=g, device="cuda")) * x
         for k, x in live.items()}
    for t in (*m.values(), *v.values()):
        t[masked_client] = 0.0
    return m, v


def step_kwargs(rates) -> dict:
    return dict(lr=CONFIG4["lr"], clip=CONFIG4["clip_grad_norm"],
                drop_attn=rates[0], drop_block=rates[1], drop_head=rates[2])


def clone_groups(groups: dict) -> dict:
    return {k: x.clone() for k, x in groups.items()}


def max_abs(a: dict, b: dict | None = None, where: dict | None = None) -> float:
    """max |a - b| (max |a| without b) over all groups, restricted to the
    entries where ``where`` is true when it is given."""
    out = 0.0
    for k in tfs.GROUP_ORDER:
        d = (a[k] - b[k]).abs() if b is not None else a[k].abs()
        if where is not None:
            d = d[where[k]]
        if d.numel():
            out = max(out, float(d.max()))
    return out


def compare_epochs(groups, m0, v0, batches, t0: int, rates, nb: int):
    """Two launches of the kernel and of the plain version from the same
    state.  Returns the kernel's (p, m, v), the plain version's, and the
    max |kernel - plain| of the loss per step."""
    kw = step_kwargs(rates)
    k = [clone_groups(s) for s in (groups, m0, v0)]
    r = [clone_groups(s) for s in (groups, m0, v0)]
    loss_err = 0.0
    for e in range(2):
        *k, kloss = tfs.run_epoch(*k, batches, 17 + e, t0 + e * nb, **kw)
        *r, rloss = tfs.run_epoch_reference(*r, batches, 17 + e, t0 + e * nb, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(kloss).all()):
            raise AssertionError("K1 loss is not finite")
        loss_err = max(loss_err, float((kloss - rloss).abs().max()) / nb)
    return k, r, loss_err


def cold_float64(groups, batches, rates, nb: int):
    """The plain version in float64 from the cold Adam state: the params
    after the two epochs of :func:`compare_epochs`, and |g| of the first
    step's clipped gradient, read from m = (1 - B1) g after that step."""
    kw = step_kwargs(rates)
    b64 = batches.double()
    p = {k: x.double() for k, x in groups.items()}
    p1, m1, v1, _ = tfs.run_epoch_reference(
        clone_groups(p), tfs.zeros_like_groups(p), tfs.zeros_like_groups(p),
        b64[:, :1], 17, 0, **kw)
    g1 = {k: x.abs() / (1.0 - tfs.B1) for k, x in m1.items()}
    m, v = tfs.zeros_like_groups(p), tfs.zeros_like_groups(p)
    for e in range(2):
        p, m, v, _ = tfs.run_epoch_reference(p, m, v, b64, 17 + e, e * nb, **kw)
    return p, g1


def check_fused_step(card: str) -> dict:
    """K1: the CUDA kernel against run_epoch_reference at config-4 shapes,
    two launches from a mid-training (warm) and from the cold Adam state,
    dropout off and on.

    Gated: the loss at 1e-4 per step; m and v each at MV_RTOL of the plain
    version's largest |m| or |v|; p at 2e-4, from the warm state on every
    entry.  From the cold state every round starts in (m = v = 0), Adam's
    first step is lr g / (|g| + 1e-8): for the few gradients within ~1e-8
    of zero, float32 rounding noise in g (any summation order, the plain
    version's own included) moves p by up to lr.  So from the cold state p
    is gated on the entries whose first-step gradient (float64) is at
    least GRAD_FLOOR, and its difference on all entries, and both float32
    versions' distance to the float64 run, are reported.  The fully masked
    client must come out bit-identical, and the w_in rows outside each
    branch's span zero."""
    C, B = CONFIG4["total_clients"], CONFIG4["batch_size"]
    nb = -(-DEPTH["cut"]["num_data_range"][1] // B)
    masked = 7
    groups, batches, live = kernel_inputs(C, nb, B, masked)
    live = {k: x != 0 for k, x in live.items()}
    for x in live.values():
        x[masked] = False
    n_live = sum(int(x.sum()) for x in live.values())
    warm = warm_state(live, masked)
    cold = (tfs.zeros_like_groups(groups), tfs.zeros_like_groups(groups))
    failures, max_err = [], 0.0
    for rates in ((0.0, 0.0, 0.0), (0.1, 0.1, 0.3)):
        for state, (m0, v0), t0 in (("warm", warm, 100), ("cold", cold, 0)):
            (kp, km, kv), (rp, rm, rv), loss_err = compare_epochs(
                groups, m0, v0, batches, t0, rates, nb)
            m_err, v_err = max_abs(km, rm), max_abs(kv, rv)
            m_tol, v_tol = MV_RTOL * max_abs(rm), MV_RTOL * max_abs(rv)
            p_all = max_abs(kp, rp)
            p_err, note = p_all, ""
            if state == "cold":
                p64, g1 = cold_float64(groups, batches, rates, nb)
                sure = {k: g1[k] >= GRAD_FLOOR for k in g1}
                p_err = max_abs(kp, rp, sure)
                below = sum(int((live[k] & ~sure[k]).sum()) for k in live)
                floors = ", ".join(
                    f">={f:g}: {max_abs(kp, rp, {k: g1[k] >= f for k in g1}):.3g}"
                    for f in (1e-8, 1e-7, 1e-5))
                note = (f"; p on all entries {p_all:.3g}, by first-step |g| {floors}; "
                        f"{below} of {n_live} live entries below {GRAD_FLOOR:g}; vs float64 "
                        f"plain on all / gated entries: kernel {max_abs(kp, p64):.3g} / "
                        f"{max_abs(kp, p64, sure):.3g}, float32 plain "
                        f"{max_abs(rp, p64):.3g} / {max_abs(rp, p64, sure):.3g}")
            max_err = max(max_err, p_err, m_err, v_err)
            log(f"[kernels] K1 fused_step dropout={rates} {state} state: max |kernel - "
                f"plain| p {p_err:.3g} (tol {PARAM_TOL}), m {m_err:.3g} (tol {m_tol:.3g}), "
                f"v {v_err:.3g} (tol {v_tol:.3g}), loss/step {loss_err:.3g} "
                f"(tol {LOSS_TOL_PER_STEP}){note}")
            if not (p_err <= PARAM_TOL and m_err <= m_tol and v_err <= v_tol
                    and loss_err <= LOSS_TOL_PER_STEP):
                failures.append(f"K1 differs from its plain version (dropout {rates}, "
                                f"{state} state)")
            if not all(torch.equal(kp[k][masked], groups[k][masked]) for k in tfs.GROUP_ORDER):
                failures.append(f"K1 moved the fully masked client ({state} state)")
            for b, (off, f) in enumerate(zip(tfs.IN_OFFS, tfs.IN_DIMS)):
                rows = torch.ones(tfs.NIN, dtype=torch.bool, device="cuda")
                rows[off:off + f] = False
                if bool(kp["w_in"][:, b, rows].abs().max() != 0):
                    failures.append("K1 trained w_in rows outside a branch's span")
    if failures:
        raise AssertionError("; ".join(failures))
    log("[kernels] K1 fully masked client bit-identical, w_in off-span rows zero")

    kw = step_kwargs((0.1, 0.1, 0.3))
    tp, tm, tv = clone_groups(groups), *cold
    ms = time_ms(lambda: tfs.run_epoch(tp, tm, tv, batches, 1, 0, **kw))
    plain_ms = time_ms(lambda: tfs.run_epoch_reference(tp, tm, tv, batches, 1, 0, **kw),
                       warmup=1, reps=5)
    work = tfs.epoch_work(C, nb, B)
    t_ops, t_bytes = work["flops"] / FP32_FLOPS * 1e3, work["bytes"] / HBM_BYTES * 1e3
    log(f"[kernels] K1 C={C} nb={nb} B={B}: kernel {ms:.3f} ms/launch, plain "
        f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"({work['flops'] / 1e9:.2f} GFLOP, {work['bytes'] / 1e6:.1f} MB)")
    return {"name": "fused_step", "route": "cuda",
            "source": "attackfl_tpu_torch/csrc/fused_step.cu",
            "replaces": "attackfl_tpu/ops/fused_step.py:524",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def main_path() -> dict:
    """The port's Simulator on the card with config 4, depth cut."""
    cfg = Config(**CONFIG4, **DEPTH["cut"], num_round=ROUNDS[1])
    for key in DEPTH["cut"]:
        log(f"[main] reduced {key}: {DEPTH['full'][key]} -> {DEPTH['cut'][key]}")
    log(f"[main] reduced num_round: {ROUNDS[0]} -> {ROUNDS[1]}")
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    torch.cuda.synchronize()
    tfs.run_epoch.launches = 0
    state, history = sim.run(state=state, verbose=False)
    launches = tfs.run_epoch.launches
    for h in history:
        log(f"[main] round {h['round']} broadcast {h['broadcast']} ok={h['ok']} "
            f"roc_auc={h.get('roc_auc', float('nan')):.4f} "
            f"train_loss={h['train_loss']:.4f} seconds={h['seconds']:.4f}")
    if not all(h["ok"] for h in history):
        raise AssertionError("a main-path round failed")
    auc = history[-1]["roc_auc"]
    if not (math.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"ROC-AUC {auc} is not above 0.5 by round {len(history)}")
    if launches != len(history) * cfg.epochs:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{len(history) * cfg.epochs}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["global_params"])):
        raise AssertionError("global params are not finite")
    log(f"[main] {len(history)} rounds ok; K1 launches {launches}; seconds per "
        f"round {[round(h['seconds'], 4) for h in history]}")
    return {"fused_step": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[device] {card}")
    check_card(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    resolve_device("cuda")

    t0 = time.perf_counter()
    _, ptxas = build.build("fused_step")
    log(f"[build] fused_step.cu in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    build.load_library("fused_step")

    kernels = [check_fused_step(card)]
    launches = main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
