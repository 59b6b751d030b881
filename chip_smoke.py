#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (attackfl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):
  1. device   -- the card's name and power limit, torch and CUDA versions;
  2. build    -- compile every CUDA kernel from csrc/ with nvcc (sm_90a),
                 one nvcc per source, all started together;
  3. kernels  -- the kernel validator's checks (validate_kernels.py), then
                 each kernel against its plain PyTorch version on the same
                 inputs at the main paths' shapes, with the stated
                 tolerances, and its time beside its roofline bound;
  4. main     -- the port's Simulator on the card with BASELINE config 4
                 (ICU TransformerModel, 100 clients, 25 LIE attackers,
                 fedavg), cut in depth only: first with local_backend
                 pallas (kernel K1), then with local_backend xla (torch
                 autograd, dropout masks from kernel K3); then the repo's
                 config.yaml as it stands, one round, through the CLI.
                 Each run's kernel launch counts are reset just before it
                 and read just after;
  5. checkpoints -- per backend, config 4 (cut) saving every round into a
                 temporary directory; then 2 rounds, a new Simulator with
                 resume=True and round 3: the same params as the run without
                 a stop, within the gap between two runs without one;
  6. stragglers -- config 4 with client_dropout_rate 0.1 under both
                 backends, and one round step whose dropped rows must equal
                 the broadcast params bit for bit; BASELINE config 3
                 (Dirichlet split, no attackers) under both backends;
  7. attacks  -- config 4 with 25 attackers of each of Random (sigma 1e6),
                 Min-Max, Min-Sum and Opt-Fang under pallas, each attack
                 step timed by CUDA events; each gamma-search attack on a
                 fixed leaked stack on the card against the same call on
                 the CPU (equal gamma sequence, rows within 1e-5);
  8. defenses -- config 4 (cut, 25 LIE attackers) under each of the nine
                 defenses with pallas, FLTrust, median and Krum with xla
                 too, median and Krum with stragglers (client_dropout_rate
                 0.1, their masked forms); the defense step timed by CUDA
                 events, the host filters of gmm and fltracer by the host
                 clock with the bytes they copy; FLTrust's root training
                 must launch K3 (2 steps an epoch) under both backends; then
                 each aggregator on one run's last client rows on the card
                 against the same call on the CPU (Krum's index, the host
                 filters' masks and ScionFL's weights equal, the rest within
                 1e-5);
  9. models   -- CNNModel (config 1), RNNModel (config 2's shape under
                 fedavg), the HAR TransformerClassifier and ResNet18 on
                 CIFAR10 with 3 Opt-Fang attackers (config 5), each at full
                 width under xla and cut in depth; one round of each under
                 torch.profiler; every round ok, the benign runs above
                 chance, K3 once per minibatch step (never under ResNet18);
                 one minibatch step of each on the card against the CPU
                 (the same masks, gradients within 1e-4 of the largest);
                 config 1's round at full depth; ResNet18's per-client
                 gradients by vmap against a loop over clients;
 10. hyper    -- hyper mode under xla, each model at its full width and
                 cut in depth: BASELINE config 2 (ICU RNNModel, 3 clients,
                 HyperNetwork, sequential), CNNModel under CNNHyper with
                 spectral normalization and the batched update, config 4's
                 shape (100 clients, 25 LIE attackers) with the embedding
                 detector, and ResNet18 on CIFAR10 with its 4.51 GB
                 hypernetwork (and one spectrally normalized generation
                 and update of it); the last round of each under
                 torch.profiler;
                 every round ok, K3 once per minibatch step (never under
                 ResNet18); generate_all, the update in each mode and the
                 detector's removals on the card against the CPU from the
                 same (warm) state;
 11. faults, dtypes, async -- a. config 4 (cut) under each backend with a
                 fault plan (a NaN storm at broadcast 2, a forced-dropout
                 cohort at broadcast 3, two failed writes of the first
                 save, a torn round-2 entry): the ok sequence, the
                 cohort's rows bit for bit, the save's retries, and a
                 resume that falls back past the torn entry to the
                 uninterrupted run's params; b. hyper config 2 (cut) with
                 a NaN storm: the failed broadcast rolls back; c. config 4
                 (cut, pallas) with the async checkpoint writer, async
                 validation and a killed writer thread: params and AUCs
                 of the synchronous run, the save's cost on the round
                 loop under each writer; d. the BF16_ACCURACY.json family
                 (16 clients, 30 rounds) in float32 and bfloat16 under
                 xla, and one bf16 minibatch step at config 4's shape on
                 the card against the CPU, its GEMMs bf16 kernels; e. the
                 HAR classifier and config 5 (cut) in bfloat16.
Each of phases 4-11 resets the kernel launch counts before each run and
requires the run's kernel to have been launched.
The second-to-last line is the kernels JSON record, the last line
``{"ok": true, "device": {...}}``.  It needs one CUDA device and the CUDA
toolkit, imports nothing of JAX, and fails when run outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attackfl_tpu_torch import cli, validate_kernels  # noqa: E402
from attackfl_tpu_torch.config import (  # noqa: E402
    AttackSpec, Config, HyperDetectionConfig, MeshConfig, load_config,
)
from attackfl_tpu_torch.faults.plan import parse_fault_plan  # noqa: E402
from attackfl_tpu_torch.data.partition import random_permutations  # noqa: E402
from attackfl_tpu_torch.data.synthetic import get_dataset  # noqa: E402
from attackfl_tpu_torch.device import resolve_device  # noqa: E402
from attackfl_tpu_torch.models.har import TransformerClassifier  # noqa: E402
from attackfl_tpu_torch.models.hyper import make_hypernetwork  # noqa: E402
from attackfl_tpu_torch.models.icu import T_HEAD, TransformerModel  # noqa: E402
from attackfl_tpu_torch.ops import aggregators, attacks, build, defenses  # noqa: E402
from attackfl_tpu_torch.ops import fused_step as tfs  # noqa: E402
from attackfl_tpu_torch.ops.pytree import (  # noqa: E402
    tree_broadcast, tree_items, tree_leaves, tree_map, tree_ravel_stacked, tree_take, unraveler,
)
from attackfl_tpu_torch.profile_round import CONFIG4, DEPTH, self_device_us  # noqa: E402
from attackfl_tpu_torch.training import local  # noqa: E402
from attackfl_tpu_torch.training import engine  # noqa: E402
from attackfl_tpu_torch.training.hyper import build_hyper_update  # noqa: E402
from attackfl_tpu_torch.training import round as tround  # noqa: E402
from attackfl_tpu_torch.training.engine import Simulator  # noqa: E402
from attackfl_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# BASELINE config 4 is cut in depth only (width, clients, attackers and
# batch stay as published): epochs and samples per client to DEPTH["cut"],
# rounds from 30 to 3
ROUNDS = (30, 3)

# published peaks of the H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM bandwidth.  INT32: an SM issues 64 INT32 lanes per
# clock against 128 FP32 lanes (Hopper architecture white paper), half the
# fp32 rate
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12
INT32_OPS = FP32_FLOPS / 2
# integer operations of one K3 mask element: fmix32 of (key ^ tensor id)
# is amortised over the client's elements, the element's own fmix32 is 2
# multiplies, 3 shifts and 4 xors, then a compare and a select
K3_OPS_PER_ELEMENT = 11
# the xla path's dropout rates (attention, block, head) at config 4
STEP_RATES = (0.1, 0.1, 0.3)
KERNELS = ("fused_step", "dropout_mask")
# rows of the chunks K1 stages for its products (MC in csrc/fused_step.cu)
K1_CHUNK_ROWS = 128
# K1's dynamic shared memory per block, SMEM_FLOATS * 4 in csrc/fused_step.cu:
# w_h1 [128, 64] and a chunk of cc [128, 128], rows padded by 4 floats
K1_SMEM_BYTES = (2 * 64 * (64 + 4) + K1_CHUNK_ROWS * (2 * 64 + 4)) * 4
REPO = os.path.dirname(os.path.abspath(__file__))

# the straggler runs' client_dropout_rate; BASELINE config 3's Dirichlet alpha
DROPOUT_RATE, CONFIG3_ALPHA = 0.1, 0.5
# the attacks of phase 7 with their args (Random's sigma is the reference's),
# each with config 4's 25 attackers
ATTACKS = (("Random", (1e6,)), ("Min-Max", ()), ("Min-Sum", ()), ("Opt-Fang", ()))
ATTACKERS = CONFIG4["attacks"][0].num_clients
# a gamma-search attack on the card against the same call on the CPU
ATTACK_ROW_TOL = 1e-5
# the kernel each backend's run must launch
BACKEND_KERNEL = {"pallas": "fused_step", "xla": "dropout_mask"}

# PR 6's config-4 FedAvg rounds (AUC, train loss) as the script prints
# them: the defenses' draws are made only when a mode asks, so these stay
BASELINE_ROUNDS = {"pallas": [(0.9301, 0.3762), (0.9350, 0.3190), (0.9371, 0.3048)],
                   "xla": [(0.9299, 0.3771), (0.9352, 0.3200), (0.9372, 0.3075)]}
# phase 8: each defense under pallas; FLTrust (whose root training is the
# autograd update whatever the backend), median and Krum under xla too;
# median and Krum in their masked forms, with stragglers
DEFENSES = ("median", "trimmed_mean", "krum", "shieldfl", "byzantine", "scionfl",
            "FLTrust", "gmm", "fltracer")
DEFENSE_RUNS = ([(mode, "pallas", 0.0) for mode in DEFENSES]
                + [(mode, "xla", 0.0) for mode in ("FLTrust", "median", "krum")]
                + [(mode, "pallas", DROPOUT_RATE) for mode in ("median", "krum")])
# an aggregate on the card against the same call on the CPU
DEFENSE_TOL = 1e-5

# phase 9, the other four models under xla, each at its full width
# (bench.py:82-110; _base_kwargs :56-75 for what they share), cut in depth
# only: config 1 (CNNModel), config 2's shape with fedavg (RNNModel; config
# 2 itself, in hyper mode, is phase 10's), the HAR classifier, and config 5
# (ResNet18 on CIFAR10 with 3 Opt-Fang attackers from round 2).  (name,
# config, cut)
BENCH_BASE = dict(num_round=30, num_data_range=(12000, 15000), epochs=5, batch_size=128,
                  lr=0.004, clip_grad_norm=1.0, genuine_rate=0.5, train_size=20000,
                  test_size=4000, random_seed=1, local_backend="xla", mode="fedavg")
ICU_CUT = dict(num_data_range=(1200, 1500), epochs=2, num_round=3)
HAR_RUN = dict(BENCH_BASE, total_clients=3, model="TransformerClassifier", data_name="HAR")
HAR_L = 561
MODEL_RUNS = (
    ("config 1", dict(BENCH_BASE, total_clients=3, model="CNNModel", data_name="ICU"),
     ICU_CUT),
    ("RNNModel", dict(BENCH_BASE, total_clients=3, model="RNNModel", data_name="ICU"), ICU_CUT),
    ("HAR", HAR_RUN, dict(num_data_range=(1200, 1500), epochs=1, num_round=2)),
    ("config 5", dict(BENCH_BASE, num_round=10, num_data_range=(256, 512), train_size=4096,
                      test_size=1024, epochs=1, batch_size=64, total_clients=16, model="ResNet18",
                      data_name="CIFAR10", attacks=(AttackSpec(
                          mode="Opt-Fang", num_clients=3, attack_round=2, args=(50.0, 1.0)),)),
     dict(num_round=3)),
)
# chance level of each run's round metric (AUC, accuracy); config 5 is
# gated on a finite NLL and ok rounds only
CHANCE = {"config 1": 0.5, "RNNModel": 0.5, "HAR": 1.0 / 6.0, "config 5": None,
          "HAR bf16": 1.0 / 6.0, "config 5 bf16": None}
# one minibatch step on the card against the CPU, from the run's last
# params: gradients within this share of the largest |g|, losses within
# STEP_LOSS_TOL * max(1, |loss|) (config 5's NLL is ~20 after Opt-Fang,
# where float32's spacing is 1.9e-6); (clients, batch) of the step where
# it is not the run's (the CPU's HAR step at B=128 takes minutes)
STEP_GRAD_RTOL, STEP_LOSS_TOL = 1e-4, 1e-5
STEP_SHAPE = {"HAR": (3, 16), "config 5": (2, 8)}

# phase 10, hyper mode under xla (hyper_lr 0.001), each model at its full
# width, cut in depth: BASELINE config 2 (bench.py:85-87) as phase 9 cuts
# RNNModel; CNNModel under CNNHyper with spectral normalization and the
# batched update; config 4's shape with its 25 LIE attackers and the
# embedding detector from round 2; ResNet18 on CIFAR10 at 4 clients (its
# hypernetwork is 101 x 11,173,962 + 21,100 floats).  (name, config, cut)
HYPER_BASE = dict(BENCH_BASE, mode="hyper", hyper_lr=0.001)
HYPER_RUNS = (
    ("config 2", dict(HYPER_BASE, total_clients=3, model="RNNModel", data_name="ICU"),
     ICU_CUT),
    ("CNNHyper", dict(HYPER_BASE, total_clients=3, model="CNNModel", data_name="ICU",
                      hyper_class="CNNHyper", hyper_spec_norm=True, hyper_update_mode="batched"),
     dict(ICU_CUT, num_round=2)),
    ("config 4 hyper", dict(HYPER_BASE, total_clients=100, model="TransformerModel",
                            data_name="ICU", attacks=CONFIG4["attacks"],
                            hyper_detection=HyperDetectionConfig(enable=True, start_round=2,
                                                                 cosine_search=5)),
     ICU_CUT),
    ("ResNet18 hyper", dict(HYPER_BASE, num_round=10, num_data_range=(256, 512),
                            train_size=4096, test_size=1024, epochs=1, batch_size=64,
                            total_clients=4, model="ResNet18", data_name="CIFAR10"),
     dict(num_round=1)),
)
# the hypernetwork on the card against the CPU from the same warm state:
# within this share of its largest magnitude; Adam's moments within
# MV_SPREAD times the CPU float32's distance from a float64 evaluation
HYPER_RTOL, MV_SPREAD = 1e-5, 4.0
# the detector check: TransformerModel's hypernetwork at this many clients,
# over this many update rounds (the detector acts from the second), at
# this hyper_lr
DETECT_C, DETECT_ROUNDS, DETECT_LR = 8, 3, 0.003

# kernel vs plain version: p absolute, loss absolute per step, m and v
# each relative to the largest magnitude of the plain version's tensor
PARAM_TOL, LOSS_TOL_PER_STEP, MV_RTOL = 2e-4, 1e-4, 1e-3
# from the cold Adam state p is gated where the first step's gradient is
# at least this large (Adam's eps is 1e-8); see check_fused_step
GRAD_FLOOR = 1e-6


# phase 11.  a: config 4 (cut) under this plan, by the CLI's grammar
FAULT_PLAN = ("nan_storm@2:clients=5,60;dropout@3:clients=0,1,2,3,4,5,6,7,8,9;"
              "ckpt_write_error@1:count=2;ckpt_torn@2")
FAULT_STORM, FAULT_COHORT = (5, 60), tuple(range(10))
# d: BF16_ACCURACY.json's family (scripts/bf16_accuracy.py:50-59, the JAX
# package's CPU run: final AUC 0.9304 in both dtypes, rounds within
# 5e-4), under xla; each final AUC within BF16_AUC_TOL of the artifact's,
# bf16's within BF16_F32_TOL of float32's
BF16_FAMILY = dict(num_round=30, total_clients=16, mode="fedavg", model="TransformerModel",
                   data_name="ICU", num_data_range=(512, 768), epochs=2, batch_size=128,
                   train_size=4096, test_size=1024, genuine_rate=0.5, local_backend="xla",
                   attacks=(AttackSpec(mode="LIE", num_clients=4, attack_round=2),))
BF16_ARTIFACT_AUC, BF16_AUC_TOL, BF16_F32_TOL = 0.9304, 0.01, 0.005
# e: the float32 rows of these runs in PERF.md §5, printed beside bf16's
F32_ROWS = {"HAR": "1.0442-1.0506 s/round, idle 0.045, peak 19.933 GiB",
           "config 5": "2.463-2.5245 s/round, idle 0.079, peak 15.110 GiB"}
# filled by main_path (each backend's run history) and checkpoint_phase
# (the gap between two config-4 runs without a stop, per backend)
MAIN_HISTORY: dict = {}
MAIN_STATES: dict = {}
RUN_GAPS: dict = {}


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


def device_ms(fn, reps: int = 200) -> float:
    """Milliseconds of one ``fn`` on the device, by CUDA events around
    ``reps`` back-to-back calls.  The device first sleeps while the host
    enqueues them all, so host time between launches does not count: the
    sleep lasts twice the host's own time for ``reps`` calls (at up to
    2 GHz), measured first.  Keep ``reps`` times the launches of one call
    under the ~1000 launches a stream queues, or the host waits on it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def ptxas_facts(ptxas: str) -> str:
    """Registers, stack frame and spills of the build's one kernel, from
    nvcc's ``-Xptxas -v`` output."""
    regs = re.search(r"Used (\d+) registers", ptxas)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ptxas)
    if not (regs and frame):
        return "registers and spills not reported (library built earlier)"
    return (f"{regs.group(1)} registers, {frame.group(1)} bytes stack frame, "
            f"{frame.group(2)} bytes spill stores, {frame.group(3)} bytes spill loads")


def check_fused_step(card: str, ptxas: str) -> dict:
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
    bound = max(t_ops, t_bytes)
    log(f"[kernels] K1 C={C} nb={nb} B={B}: kernel {ms:.3f} ms/launch, plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
        f"({work['flops'] / 1e9:.2f} GFLOP, {work['bytes'] / 1e6:.1f} MB)")
    log(f"[kernels] K1 facts: {K1_SMEM_BYTES} bytes of dynamic shared memory per block; "
        f"{ptxas_facts(ptxas)}; {work['flops'] / ms / 1e9:.3f} TFLOP/s of live products "
        f"achieved; {bound / ms:.2%} of the bound")
    # A step's time against the batch size.  The forward and input-gradient
    # products (gemm) run their register-tile loops over whole chunks of
    # K1_CHUNK_ROWS rows, so within one chunk their cost is fixed and the
    # slope is the rest of the row work: the weight-gradient loops (gemm_tn
    # walks the real rows), LayerNorms, masks, loss, staging and epilogues.
    # Over whole chunks the slope is all row work and the intercept the work
    # that does not grow with the rows (global-norm clip, Adam, weight
    # staging, barriers).
    sizes = (32, 64, 128, 256, 384)
    per_step = []
    for rows in sizes:
        rb = batches.repeat(1, 1, -(-rows // B), 1)[:, :, :rows].contiguous()
        per_step.append(time_ms(lambda: tfs.run_epoch(tp, tm, tv, rb, 1, 0, **kw), reps=15) / nb)
    one = np.polyfit(sizes[:3], per_step[:3], 1)
    whole = np.polyfit(sizes[2:], per_step[2:], 1)
    parts = {"row-independent (clip, Adam, weight staging, barriers)": whole[1],
             "forward and input-gradient tile loops": (whole[0] - one[0]) * K1_CHUNK_ROWS,
             "row-proportional work (weight-gradient loops, LayerNorms, masks, loss, "
             "staging, epilogues)": one[0] * K1_CHUNK_ROWS}
    step = sum(parts.values())
    log(f"[kernels] K1 ms per step at C={C} by batch size: "
        f"{', '.join(f'B={r} {t:.4f}' for r, t in zip(sizes, per_step))}; over whole chunks "
        f"{whole[1]:.4f} ms + {whole[0] * 1e3:.3f} us per row, within one chunk "
        f"{one[0] * 1e3:.3f} us per row; so a {K1_CHUNK_ROWS}-row step of {step:.4f} ms is "
        + ", ".join(f"{name} {t:.4f} ms ({t / step:.1%})" for name, t in parts.items()))
    return {"name": "fused_step", "route": "cuda",
            "source": "attackfl_tpu_torch/csrc/fused_step.cu",
            "replaces": "attackfl_tpu/ops/fused_step.py:524",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def check_validator() -> None:
    """The kernel validator's checks (a)-(c) on the card."""
    out = validate_kernels.run_checks("cuda")
    a, b, c = out["autodiff_match"], out["mask_statistics"], out["dropout_on_step"]
    log(f"[kernels] validator (a) K1 vs autograd, dropout off, {validate_kernels.C} clients: "
        f"max |diff| p {a['max_abs_param_diff']:.3g} on live entries with first |g| >= "
        f"{validate_kernels.GRAD_FLOOR:g} (tol {validate_kernels.PARAM_TOL}; "
        f"{a['live_entries_below_grad_floor']} of {a['live_entries']} below; all entries "
        f"{a['max_abs_param_diff_all_entries']:.3g}), loss {a['loss_diff']:.3g} "
        f"(tol {validate_kernels.LOSS_TOL}) ok={a['ok']}")
    for rate in (0.1, 0.3, 0.5):
        r = b[f"rate_{rate}"]
        log(f"[kernels] validator (b) K3 {validate_kernels.MASK_SHAPE} rate {rate}: keep "
            f"{r['keep_frac']:.5f} (expected {r['expected']:.1f} +- {r['tol_4sigma']:.5f}), "
            f"mean {r['mask_mean']:.5f}, values ok {r['values_ok']}, bit-equal to plain "
            f"{r['bit_equal_to_plain']}")
    log(f"[kernels] validator (c) K1 dropout on: finite {c['finite']}, max |on - off| "
        f"{c['max_abs_vs_dropout_off']:.3g}, mean loss {c['mean_loss']:.4f} ok={c['ok']}")
    if not out["ok"]:
        raise AssertionError("the kernel validator failed: " + json.dumps(
            {k: out[k]["ok"] for k in ("autodiff_match", "mask_statistics", "dropout_on_step")}))


def k3_bound_ms(C: int, elements: int) -> tuple[float, float]:
    """K3's bound in ms, (bytes, operations): ``elements`` floats written
    and C int64 keys read at HBM_BYTES; K3_OPS_PER_ELEMENT int32
    operations per element at INT32_OPS."""
    return ((4 * elements + 8 * C) / HBM_BYTES * 1e3,
            K3_OPS_PER_ELEMENT * elements / INT32_OPS * 1e3)


def check_step_set(label: str, C: int, specs) -> float:
    """One K3 launch of a step's mask set against the plain version, bit
    for bit; returns the max |kernel - plain|."""
    keys = tfs.client_keys(2024, 5, torch.arange(C, device="cuda"))
    launches = tfs.fill_masks.launches
    got = tfs.fill_masks(keys, specs)
    torch.cuda.synchronize()
    if tfs.fill_masks.launches != launches + 1:
        raise AssertionError("K3 took more than one launch for a step's masks")
    err = 0.0
    for g, w, (tensor_id, rows, width, rate) in zip(got, tfs.dropout_masks(keys, specs), specs):
        err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"K3 differs from dropout_masks ({label}), tensor {tensor_id} "
                                 f"[{C}, {rows}, {width}] rate {rate}")
    log(f"[kernels] K3 {label}: one launch of {len(specs)} tensors "
        f"{[(r, w) for _, r, w, _ in specs]}, bit-equal to its plain version")
    return err


def check_dropout_mask() -> dict:
    """K3 against its plain version, bit for bit: one tensor per launch at
    the validator's shape and at every shape the xla path's step asks of
    it at the config-4 width; a whole step's nine tensors in one launch
    (``fill_masks``, as ``step_masks`` calls it) at C=100 and at C=150,
    and the HAR classifier's nine at C=3, B=128, L=561, whose row counts
    differ within the launch.  Then its time per step-launch at C=100,
    B=128 beside its bound and beside the same nine tensors drawn one
    launch each, the one-tensor ``[100, 128, 64]`` time, and its time at
    the HAR set beside that set's bound."""
    C, B = CONFIG4["total_clients"], CONFIG4["batch_size"]
    model = TransformerModel()
    step = model.mask_specs([(B,)], STEP_RATES)
    big = (C, B, 64)
    path_shapes = sorted({(C, B, w) for _, _, w, _ in step})
    max_err = 0.0
    for shape in [(1,) + validate_kernels.MASK_SHAPE] + path_shapes:
        keys = tfs.client_keys(2024, 5, torch.arange(shape[0], device="cuda"))
        for rate in (0.1, 0.3):
            got = tfs.fill_mask(keys, T_HEAD, shape[1], shape[2], rate)
            want = tfs.dropout_mask(keys, T_HEAD, shape[1], shape[2], rate)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"K3 differs from dropout_mask at {shape}, rate {rate}")
        log(f"[kernels] K3 dropout_mask {list(shape)}: bit-equal to its plain version "
            f"at rates 0.1 and 0.3")
    for clients in (C, 150):
        max_err = max(max_err, check_step_set(f"config-4 step set C={clients} B={B} rates "
                                              f"{STEP_RATES}", clients, step))
    har_C, har_B = HAR_RUN["total_clients"], HAR_RUN["batch_size"]
    har = TransformerClassifier().mask_specs([(har_B, HAR_L)], TransformerClassifier().dropout_rates)
    max_err = max(max_err, check_step_set(f"HAR step set C={har_C} B={har_B} L={HAR_L}",
                                          har_C, har))

    keys = tfs.client_keys(2024, 5, torch.arange(C, device="cuda"))
    n_step = C * sum(r * w for _, r, w, _ in step)
    t_bytes, t_ops = k3_bound_ms(C, n_step)
    bound = max(t_bytes, t_ops)
    ms = device_ms(lambda: tfs.fill_masks(keys, step))
    nine_ms = device_ms(lambda: [tfs.fill_mask(keys, t, r, w, p) for t, r, w, p in step],
                        reps=100)
    plain_ms = device_ms(lambda: tfs.dropout_masks(keys, step), reps=3)
    # the same launch after a 64 MB write, so that the arena's lines are
    # not in L2 and dirty lines of another buffer must leave for HBM first
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    cold_ms = (device_ms(lambda: (flush.zero_(), tfs.fill_masks(keys, step)))
               - device_ms(flush.zero_))
    log(f"[kernels] K3 step C={C} B={B}: kernel {ms * 1e3:.3f} us/launch, the same nine tensors "
        f"one launch each {nine_ms * 1e3:.3f} us, after a 64 MB write {cold_ms * 1e3:.3f} us, "
        f"plain {plain_ms * 1e3:.3f} us; bound {bound * 1e3:.3f} us ({4 * n_step / 1e6:.2f} MB "
        f"written at 3.35 TB/s; {K3_OPS_PER_ELEMENT * n_step / 1e6:.1f} M int32 ops take "
        f"{t_ops * 1e3:.3f} us); {bound / ms:.1%} of the bound")

    one_ms = device_ms(lambda: tfs.fill_mask(keys, T_HEAD, B, big[2], 0.1))
    one_plain = device_ms(lambda: tfs.dropout_mask(keys, T_HEAD, B, big[2], 0.1), reps=20)
    one_bytes, one_ops = k3_bound_ms(C, math.prod(big))
    log(f"[kernels] K3 {list(big)}: kernel {one_ms * 1e3:.3f} us/launch, plain "
        f"{one_plain * 1e3:.3f} us, bound {max(one_bytes, one_ops) * 1e3:.3f} us "
        f"({4 * math.prod(big) / 1e6:.2f} MB written at 3.35 TB/s; "
        f"{K3_OPS_PER_ELEMENT * math.prod(big) / 1e6:.1f} M int32 ops take "
        f"{one_ops * 1e3:.3f} us)")

    har_keys = tfs.client_keys(2024, 5, torch.arange(har_C, device="cuda"))
    n_har = har_C * sum(r * w for _, r, w, _ in har)
    har_bytes, har_ops = k3_bound_ms(har_C, n_har)
    har_ms = device_ms(lambda: tfs.fill_masks(har_keys, har), reps=20)
    har_plain = device_ms(lambda: tfs.dropout_masks(har_keys, har), reps=2)
    log(f"[kernels] K3 HAR step set C={har_C} B={har_B} L={HAR_L}: kernel "
        f"{har_ms * 1e3:.3f} us/launch, plain {har_plain * 1e3:.3f} us; bound "
        f"{max(har_bytes, har_ops) * 1e3:.3f} us ({4 * n_har / 1e6:.1f} MB written at 3.35 "
        f"TB/s; {K3_OPS_PER_ELEMENT * n_har / 1e6:.1f} M int32 ops take {har_ops * 1e3:.3f} "
        f"us); {max(har_bytes, har_ops) / har_ms:.1%} of the bound")
    return {"name": "dropout_mask", "route": "cuda",
            "source": "attackfl_tpu_torch/csrc/dropout_mask.cu",
            "replaces": "scripts/tpu_validate_pallas.py:125",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def xla_epoch_ms() -> float:
    """One epoch of the xla local update at C=100, nb=12, B=128 (the
    config-4 cut): CUDA events around the call (host time included), and
    the device time of its kernels and copies under torch.profiler."""
    C, B = CONFIG4["total_clients"], CONFIG4["batch_size"]
    hi = DEPTH["cut"]["num_data_range"][1]
    data = {k: torch.as_tensor(v, device="cuda") for k, v in get_dataset(
        "ICU", "train", CONFIG4["train_size"], CONFIG4["random_seed"]).items()}
    update = local.build_local_update(
        TransformerModel(), "ICU", data, epochs=1, batch_size=B, lr=CONFIG4["lr"],
        clip_grad_norm=CONFIG4["clip_grad_norm"])
    params = TransformerModel().init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, data["label"].shape[0], (C, hi), generator=g, device="cuda")
    mask = torch.ones((C, hi), dtype=torch.bool, device="cuda")
    perms = torch.argsort(torch.rand((1, C, hi), generator=g, device="cuda"), dim=-1)
    ms = time_ms(lambda: update(params, idx, mask, perms, 0), warmup=1, reps=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        update(params, idx, mask, perms, 0)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and self_device_us(e) > 0]
    busy = sum(self_device_us(e) for e in device) / 1e3
    nb = -(-hi // B)
    log(f"[kernels] xla local update C={C} nb={nb} B={B}: {ms:.3f} ms/epoch "
        f"(CUDA events around the call, host time included), device busy {busy:.3f} ms/epoch, "
        f"{sum(e.count for e in device) / nb:.0f} device kernels and copies per step "
        f"(torch.profiler)")
    return ms


def cut_config(**kw) -> Config:
    """BASELINE config 4 cut in depth (``DEPTH["cut"]``, ``ROUNDS[1]``
    rounds), with ``kw`` on top."""
    return Config(**{**CONFIG4, **DEPTH["cut"], "num_round": ROUNDS[1], **kw})


def max_param_gap(a: dict, b: dict) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_config(cfg: Config, label: str, auc_gate: bool = True, all_ok: bool = True,
               sim: Simulator | None = None, save_checkpoints: bool = False,
               ) -> tuple[Simulator, dict, list, dict]:
    """The Simulator on the card from a fresh state; kernel launch counts
    over the run.  Gates: finite params, and unless turned off every round
    ok and the last ROC-AUC above 0.5."""
    sim = sim or Simulator(cfg, device="cuda")
    state = sim.init_state()
    torch.cuda.synchronize()
    tfs.run_epoch.launches = tfs.fill_masks.launches = 0
    state, history = sim.run(state=state, save_checkpoints=save_checkpoints, verbose=False)
    launches = {"fused_step": tfs.run_epoch.launches, "dropout_mask": tfs.fill_masks.launches}
    for h in history:
        log(f"[main] {label} round {h['round']} broadcast {h['broadcast']} ok={h['ok']} "
            f"roc_auc={h.get('roc_auc', float('nan')):.4f} "
            f"train_loss={h['train_loss']:.4f} seconds={h['seconds']:.4f}")
    if all_ok and not all(h["ok"] for h in history):
        raise AssertionError(f"a {label} round failed")
    auc = history[-1].get("roc_auc", float("nan"))
    if auc_gate and not (math.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"{label}: ROC-AUC {auc} is not above 0.5 by round {len(history)}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["global_params"])):
        raise AssertionError(f"{label}: global params are not finite")
    kernel = BACKEND_KERNEL[cfg.local_backend]
    if launches[kernel] == 0:
        raise AssertionError(f"{label}: kernel {kernel} was not launched")
    return sim, state, history, launches


def main_path() -> tuple[dict, dict]:
    """Config 4, depth cut, under both local backends, then the repo's
    config.yaml.  Returns the kernels' launch counts (K1's from the
    pallas run, K3's from the xla run) and each backend's final state."""
    for key in DEPTH["cut"]:
        log(f"[main] reduced {key}: {DEPTH['full'][key]} -> {DEPTH['cut'][key]}")
    log(f"[main] reduced num_round: {ROUNDS[0]} -> {ROUNDS[1]}")
    counts, states = {}, {}
    for backend in ("pallas", "xla"):
        cfg = cut_config(local_backend=backend)
        _, states[backend], history, launches = run_config(cfg, backend)
        nb = -(-cfg.num_data_range[1] // cfg.batch_size)
        expect = ({"fused_step": len(history) * cfg.epochs, "dropout_mask": 0}
                  if backend == "pallas" else
                  {"fused_step": 0, "dropout_mask": len(history) * cfg.epochs * nb})
        if launches != expect:
            raise AssertionError(f"{backend}: kernel launches {launches}, expected {expect}")
        MAIN_HISTORY[backend] = history
        got = [(round(h["roc_auc"], 4), round(h["train_loss"], 4)) for h in history]
        if got != BASELINE_ROUNDS[backend]:
            raise AssertionError(f"{backend}: rounds {got} differ from the earlier slices' "
                                 f"{BASELINE_ROUNDS[backend]}")
        log(f"[main] {backend}: {len(history)} rounds ok; launches {launches}; seconds per "
            f"round {[round(h['seconds'], 4) for h in history]}")
        counts.update({k: v for k, v in launches.items() if v})

    # config.yaml as it stands: 3 clients at full depth, local_backend xla;
    # it checkpoints into its log_path, ".", so it runs in a temporary
    # working directory
    path = os.path.join(REPO, "config.yaml")
    cfg = load_config(path)
    per_round = cfg.epochs * -(-cfg.num_data_range[1] // cfg.batch_size)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    tfs.run_epoch.launches = tfs.fill_masks.launches = 0
    t0 = time.perf_counter()
    try:
        os.chdir(workdir)
        rc = cli.run_main(["--config", path, "--rounds", "1"])
        torch.cuda.synchronize()
    finally:
        os.chdir(REPO)
    seconds = time.perf_counter() - t0
    written = sorted(os.listdir(workdir))
    shutil.rmtree(workdir)
    k1, k3 = tfs.run_epoch.launches, tfs.fill_masks.launches
    if rc != 0 or k1 != 0 or k3 == 0 or k3 % per_round:
        raise AssertionError(f"config.yaml run: exit {rc}, K1 launches {k1}, K3 launches {k3}")
    if "manifest.json" not in written:
        raise AssertionError(f"config.yaml run wrote no checkpoint manifest: {written}")
    log(f"[main] config.yaml, 1 round: ok in {seconds:.3f} s (construction included); "
        f"K1 launches {k1}, K3 launches {k3} ({k3 // per_round} round(s) trained); "
        f"wrote {written}")
    return counts, states


def checkpoint_phase(main_states: dict) -> None:
    """Per backend: a run that saves every round (each save timed), then 2
    rounds, a new Simulator with resume=True and round 3.  The resumed
    params are held to the gap between the main path's run and the
    saving run, two runs without a stop (0 when the runs are
    deterministic)."""
    for backend in ("pallas", "xla"):
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            whole_dir, cut_dir = os.path.join(root, "whole"), os.path.join(root, "cut")
            sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=whole_dir),
                            device="cuda")
            save_s = []
            save = sim.save_checkpoint

            def timed_save(state, save=save, save_s=save_s):
                t0 = time.perf_counter()
                if not save(state):
                    raise AssertionError(f"{backend}: a checkpoint write failed")
                save_s.append(time.perf_counter() - t0)
                return True

            sim.save_checkpoint = timed_save
            _, whole, _, _ = run_config(sim.cfg, f"{backend} checkpointed", sim=sim,
                                        save_checkpoints=True)
            gap = max_param_gap(main_states[backend]["global_params"], whole["global_params"])
            RUN_GAPS[backend] = gap
            sizes = [e["bytes"] for e in sim.checkpoints.read_manifest()["entries"]]
            log(f"[checkpoints] {backend}: two runs without a stop differ by max |d params| "
                f"{gap:.3e}; saves of rounds 1-3: {sizes} bytes in "
                f"{[round(t, 4) for t in save_s]} s")

            first = Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir),
                              device="cuda")
            first.run(num_rounds=2, verbose=False)
            resumed_sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir,
                                               resume=True), device="cuda")
            t0 = time.perf_counter()
            state = resumed_sim.load_or_init_state()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            tfs.run_epoch.launches = tfs.fill_masks.launches = 0
            resumed, history = resumed_sim.run(state=state, verbose=False)
            launches = {"fused_step": tfs.run_epoch.launches,
                        "dropout_mask": tfs.fill_masks.launches}
            rounds = [e["round"] for e in resumed_sim.checkpoints.read_manifest()["entries"]]
            resume_gap = max_param_gap(resumed["global_params"], whole["global_params"])
            log(f"[checkpoints] {backend}: resume load {load_s:.4f} s from round "
                f"{state['completed_rounds']}; resumed rounds {[h['round'] for h in history]} "
                f"ok={[h['ok'] for h in history]}; manifest rounds {rounds}; launches {launches}; "
                f"resumed vs uninterrupted max |d params| {resume_gap:.3e}")
            if (state["completed_rounds"] != 2 or [h["round"] for h in history] != [3]
                    or not all(h["ok"] for h in history) or rounds != [1, 2, 3]
                    or launches[BACKEND_KERNEL[backend]] == 0 or resume_gap > gap):
                raise AssertionError(f"{backend}: resume does not continue the run")
        finally:
            shutil.rmtree(root)


def dropped_rows_check(sim: Simulator, label: str) -> None:
    """One round step with stragglers: every dropped client's row is the
    broadcast params bit for bit."""
    state = sim.init_state()
    draws = sim.draw_round(torch.Generator(device=sim.device).manual_seed(11))
    stacked = sim.round_step(state["global_params"], state["prev_genuine"], False, draws, 1)[0]
    dropped = torch.nonzero(~draws.kept).flatten()
    if dropped.numel() == 0:
        raise AssertionError(f"{label}: the draw dropped no client")
    for (path, rows), (_, p) in zip(tree_items(stacked), tree_items(state["global_params"])):
        if not torch.equal(rows[dropped], p.expand((dropped.numel(),) + tuple(p.shape))):
            raise AssertionError(f"{label}: a dropped client's {path} moved")
    log(f"[stragglers] {label}: one round step dropped clients {dropped.tolist()}; their "
        "rows equal the broadcast params bit for bit")


def straggler_phase() -> None:
    """Config 4 with stragglers, then BASELINE config 3 (Dirichlet split,
    no attackers), each under both backends."""
    for backend in ("pallas", "xla"):
        cfg = cut_config(local_backend=backend, client_dropout_rate=DROPOUT_RATE)
        sim, _, history, launches = run_config(cfg, f"{backend} stragglers")
        log(f"[stragglers] {backend} client_dropout_rate {DROPOUT_RATE}: {len(history)} rounds "
            f"ok; launches {launches}; seconds per round "
            f"{[round(h['seconds'], 4) for h in history]}")
        dropped_rows_check(sim, backend)
    for backend in ("pallas", "xla"):
        cfg = cut_config(local_backend=backend, attacks=(), partition="dirichlet",
                         dirichlet_alpha=CONFIG3_ALPHA)
        _, _, history, launches = run_config(cfg, f"{backend} config 3", auc_gate=False)
        log(f"[stragglers] {backend} config 3 (dirichlet alpha {CONFIG3_ALPHA}, no attackers): "
            f"{len(history)} rounds ok; launches {launches}; AUC "
            f"{[round(h['roc_auc'], 4) for h in history]}; seconds per round "
            f"{[round(h['seconds'], 4) for h in history]}")


def timed_calls(obj, name: str, events: list, host: bool = False):
    """Replace ``obj.name`` by a wrapper that records each call's CUDA
    events (or, with ``host``, host seconds after a device sync) in
    ``events``; returns a function that restores it."""
    inner = getattr(obj, name)

    def wrapper(*a, **k):
        if host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **k)
            events.append((time.perf_counter() - t0, a))
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **k)
        end.record()
        events.append((start, end, a))
        return out

    setattr(obj, name, wrapper)
    return lambda: setattr(obj, name, inner)


def attack_on_card_and_cpu(mode: str, state: dict, leak_k: int, device) -> None:
    """One gamma-search attack call from a fixed leaked stack (the run's
    final leak pool, a seeded leak sample per attacker) on the card and on
    the CPU copy: the same gamma sequence, rows within ATTACK_ROW_TOL."""
    pool = state["prev_genuine"]
    n_genuine = tree_leaves(pool)[0].shape[0]
    leaks = random_permutations(torch.Generator().manual_seed(5),
                                (ATTACKERS, n_genuine))[:, :leak_k]
    outs, traces = [], []
    for dev in (device, "cpu"):
        on = tree_map(lambda x: x.to(dev), pool)
        own = tree_broadcast(tree_map(lambda x: x.to(dev), state["global_params"]), ATTACKERS)
        trace: list = []
        outs.append(attacks.apply_attack(mode, own, tree_take(on, leaks.to(dev)), (), dim=1,
                                         trace=trace))
        traces.append([g.cpu() for g, _, _ in trace])
    same = len(traces[0]) == len(traces[1]) and all(
        torch.equal(a, b) for a, b in zip(*traces))
    err = max(float((x.cpu() - y).abs().max()) for x, y in zip(tree_leaves(outs[0]),
                                                                tree_leaves(outs[1])))
    log(f"[attacks] {mode}: one call on a fixed leaked stack [{ATTACKERS}, {leak_k}, P]: "
        f"{len(traces[0])} gamma steps, gamma sequence card == CPU: {same} "
        f"(card {[round(float(g[0]), 4) for g in traces[0]]}); max |card - CPU| {err:.3e}")
    if not same or err > ATTACK_ROW_TOL:
        raise AssertionError(f"{mode}: the card's attack disagrees with the CPU's")


def attack_phase() -> None:
    """Config 4 with its 25 attackers of each attack under pallas: the run ends
    without raising with finite params (the AUC is printed, not gated: an
    attack may drive it to 0.5); each attack step timed by CUDA events."""
    for mode, args in ATTACKS:
        cfg = cut_config(attacks=(AttackSpec(mode=mode, num_clients=ATTACKERS,
                                             attack_round=2, args=args),))
        events = []
        restore = timed_calls(tround, "map_attackers", events)
        try:
            sim, state, history, launches = run_config(cfg, f"attack {mode}", auc_gate=False,
                                                       all_ok=False)
        finally:
            restore()
        torch.cuda.synchronize()
        ms = [round(s.elapsed_time(e), 3) for s, e, _ in events]
        if len(ms) != sum(1 for h in history if h["broadcast"] >= 2):
            raise AssertionError(f"{mode}: {len(ms)} attack steps in {len(history)} rounds")
        log(f"[attacks] {mode} {args}: rounds ok {[h['ok'] for h in history]}; AUC "
            f"{[round(h.get('roc_auc', float('nan')), 4) for h in history]}; launches "
            f"{launches}; attack step (leak gather and attack, CUDA events) {ms} ms per "
            f"attacking round; seconds per round {[round(h['seconds'], 4) for h in history]}")
        if mode in attacks.GAMMA_SEARCHES:
            attack_on_card_and_cpu(mode, state, sim.leak_k, sim.device)


def defense_run(mode: str, backend: str, rate: float) -> tuple[Simulator, tuple]:
    """One cut config-4 run under ``mode``: its gates and times.  Returns
    the Simulator and the last aggregate call's args."""
    label = f"{mode} {backend}" + (f" stragglers {rate}" if rate else "")
    cfg = cut_config(mode=mode, local_backend=backend, client_dropout_rate=rate)
    sim = Simulator(cfg, device="cuda")
    agg_events, filter_host, filter_only = [], [], []
    restore = [timed_calls(sim, "aggregate", agg_events)]
    if mode in ("gmm", "fltracer"):
        fn = "gmm_filter" if mode == "gmm" else "fltracer_anomalies"
        restore += [timed_calls(engine, "host_filter", filter_host, host=True),
                    timed_calls(engine.defenses, fn, filter_only, host=True)]
    try:
        sim, _, history, launches = run_config(cfg, label, sim=sim)
    finally:
        for r in restore:
            r()
    torch.cuda.synchronize()
    aggregated = len(agg_events)
    ms = [round(s.elapsed_time(e), 3) for s, e, _ in agg_events]
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    root_steps = aggregated * cfg.epochs * -(-tround.ROOT_SIZE // tround.ROOT_BATCH)
    clients = ({"fused_step": len(history) * cfg.epochs, "dropout_mask": 0}
               if backend == "pallas" else
               {"fused_step": 0, "dropout_mask": len(history) * cfg.epochs * nb})
    expect = dict(clients)
    if mode == "FLTrust":
        expect["dropout_mask"] += root_steps
    if launches != expect or aggregated != len(history):
        raise AssertionError(f"{label}: launches {launches} over {aggregated} aggregated "
                             f"rounds, expected {expect}")
    extra = ""
    if mode == "FLTrust":
        extra = f"; K3 launches of the root training {root_steps} (2 steps an epoch)"
    if filter_host:
        nbytes = [a[0].nbytes for _, a in filter_only]
        extra = (f"; host filter (copy to the host and {fn}) "
                 f"{[round(t * 1e3, 3) for t, _ in filter_host]} ms, of which {fn} "
                 f"{[round(t * 1e3, 3) for t, _ in filter_only]} ms, {nbytes} bytes copied; "
                 + ("kept " + str([h.get("gmm_kept") for h in history]) if mode == "gmm" else
                    "anomalies " + str([h.get("fltracer_anomalies") for h in history])))
    log(f"[defenses] {label}: rounds ok {[h['ok'] for h in history]}; AUC "
        f"{[round(h['roc_auc'], 4) for h in history]}; launches {launches}; defense step "
        f"(sim.aggregate, CUDA events) {ms} ms per round{extra}; seconds per round "
        f"{[round(h['seconds'], 4) for h in history]}")
    return sim, agg_events[-1][2]


def defenses_on_card_and_cpu(sim: Simulator, args: tuple) -> None:
    """Each aggregator on one run's last round (its broadcast params and
    client rows, sizes and mask) on the card and on the CPU: Krum's index,
    the host filters' keep masks and ScionFL's weights from the same
    uniforms equal; the aggregates within DEFENSE_TOL.  FLTrust's combine
    is compared from the card's root params; its root training on the
    two devices is reported (Adam's first step from m = v = 0 turns float32
    noise in near-zero gradients into up to lr)."""
    global_params, stacked, sizes, weights_mask, draws = args
    cpu = {k: v.cpu() for k, v in sim.test_data.items()}
    to_cpu = lambda t: tree_map(lambda x: x.cpu(), t)  # noqa: E731
    host = (to_cpu(global_params), to_cpu(stacked), sizes.cpu(), weights_mask.cpu())
    n_clients = tree_leaves(stacked)[0].shape[0]
    dev, model = sim.device, TransformerModel()
    uniform = torch.rand((n_clients, sim.num_params),
                         generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    root_perms = random_permutations(torch.Generator(device=dev).manual_seed(8),
                                     (sim.cfg.epochs, 1, tround.ROOT_SIZE))
    card_draws = dataclasses.replace(draws, uniform=uniform, root_perms=root_perms, root_seed=3)
    cpu_draws = dataclasses.replace(card_draws, uniform=uniform.cpu(),
                                    root_perms=root_perms.cpu())
    for mode in DEFENSES:
        cfg = cut_config(mode=mode)
        card_wm, cpu_wm = weights_mask, host[3]
        note = ""
        if mode in ("gmm", "fltracer"):
            keep_card, _ = engine.host_filter(mode, stacked, sim.attacker_mask, cfg.random_seed)
            keep_cpu, _ = engine.host_filter(mode, host[1], sim.attacker_mask, cfg.random_seed)
            if not np.array_equal(keep_card, keep_cpu):
                raise AssertionError(f"{mode}: the keep mask differs between card and CPU")
            note = f"keep mask equal ({int(keep_card.sum())} kept)"
            card_wm = weights_mask * torch.as_tensor(keep_card, device=dev)
            cpu_wm = host[3] * torch.as_tensor(keep_cpu)
        if mode == "krum":
            i_card = int(aggregators.krum_select(stacked, cfg.krum_f))
            i_cpu = int(aggregators.krum_select(host[1], cfg.krum_f))
            if i_card != i_cpu:
                raise AssertionError(f"krum: index {i_card} on the card, {i_cpu} on the CPU")
            note = f"index {i_card} on both"
        if mode == "scionfl":
            dist = aggregators.scionfl_distances(stacked, uniform)
            w_card = aggregators.scionfl_weights(stacked, sizes * weights_mask, uniform)
            w_cpu = aggregators.scionfl_weights(host[1], host[2] * host[3], uniform.cpu())
            if not torch.equal(w_card.cpu(), w_cpu):
                raise AssertionError("scionfl: the weights differ between card and CPU")
            thresh = aggregators.scionfl_threshold(dist)
            gaps = (dist - thresh).abs()
            margin = float(torch.sort(gaps).values[1] / thresh.abs())
            note = (f"weights equal ({int((w_card > 0).sum())} kept); closest client to the "
                    f"threshold {margin:.3e} of it apart")
        if mode == "FLTrust":
            kw = dict(epochs=cfg.epochs, batch_size=tround.ROOT_BATCH, lr=cfg.lr,
                      clip_grad_norm=cfg.clip_grad_norm)
            root_card = local.build_root_update(
                model, "ICU", {k: v[:tround.ROOT_SIZE] for k, v in sim.test_data.items()}, **kw)
            root_cpu = local.build_root_update(
                model, "ICU", {k: v[:tround.ROOT_SIZE] for k, v in cpu.items()}, **kw)
            r_card = root_card(global_params, card_draws.root_perms, card_draws.root_seed)
            r_cpu = root_cpu(host[0], cpu_draws.root_perms, cpu_draws.root_seed)
            root_gap = max(float((a.cpu() - b).abs().max())
                           for a, b in zip(tree_leaves(r_card), tree_leaves(r_cpu)))
            delta = lambda r, g: tree_map(torch.sub, r, g)  # noqa: E731
            deltas = lambda s, g: tree_map(lambda x, y: x - y.unsqueeze(0), s, g)  # noqa: E731
            out_card = aggregators.fltrust_combine(global_params, deltas(stacked, global_params),
                                                   delta(r_card, global_params))
            r_host = to_cpu(r_card)
            out_cpu = aggregators.fltrust_combine(host[0], deltas(host[1], host[0]),
                                                  delta(r_host, host[0]))
            note = (f"combine from the card's root params; root training card vs CPU max "
                    f"|d params| {root_gap:.3e}")
        else:
            card_fn = tround.build_aggregator(model, cfg, sim.test_data)
            cpu_fn = tround.build_aggregator(model, cfg, cpu)
            out_card = card_fn(global_params, stacked, sizes, card_wm, card_draws)
            out_cpu = cpu_fn(host[0], host[1], host[2], cpu_wm, cpu_draws)
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(tree_leaves(out_card), tree_leaves(out_cpu)))
        log(f"[defenses] {mode} on one run's last round, card vs CPU: max |d aggregate| "
            f"{err:.3e} (tol {DEFENSE_TOL}){'; ' + note if note else ''}")
        if not err <= DEFENSE_TOL:
            raise AssertionError(f"{mode}: the card's aggregate differs from the CPU's")


def defense_phase() -> None:
    """The defense runs of DEFENSE_RUNS, then the card against the CPU on
    the last round of the first run."""
    first = None
    for mode, backend, rate in DEFENSE_RUNS:
        sim, args = defense_run(mode, backend, rate)
        first = first or (sim, args)
    defenses_on_card_and_cpu(*first)


def busy_us(events) -> float:
    """Microseconds in which at least one of the device ``events`` (kernels
    and copies) ran: the union of their intervals, so kernels that overlap
    on several streams count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def round_profile(sim: Simulator, state: dict) -> tuple[dict, dict, dict]:
    """One round under torch.profiler: (new state, metrics, profile) with
    the wall seconds under the profiler, the device-busy seconds (the
    union of kernel and copy intervals), and K3's device microseconds."""
    torch.cuda.synchronize()
    # device activity only: the host-side events of a round number in the
    # hundreds of thousands and take longer to collect than the round
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = sim.run_round(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    if not device:
        raise AssertionError("torch.profiler recorded no device activity in the round")
    k3 = sum(e.time_range.elapsed_us() for e in device if "fill_masks" in e.name)
    return state, metrics, {"wall_s": wall, "busy_s": busy_us(device) / 1e6, "k3_us": k3}


def step_on_card_and_cpu(label: str, sim: Simulator, params: dict, C: int, B: int) -> None:
    """One minibatch step of C clients from the same params (``params``,
    nudged per client by a seeded 1e-3), batch and K3 masks on the card
    and on the CPU: the masks equal, per-client gradients within
    STEP_GRAD_RTOL of the largest |g|, losses within STEP_LOSS_TOL of
    max(1, |loss|)."""
    model, data_name = sim.model, sim.cfg.data_name
    names = local.INPUTS[data_name]
    gen = torch.Generator().manual_seed(13)
    n = sim.train_data["label"].shape[0]
    idx = torch.randint(0, n, (C, B), generator=gen)
    template = tree_map(lambda x: x.cpu(), params)
    flat = tree_ravel_stacked(tree_broadcast(template, C))
    flat = flat + 1e-3 * torch.randn(flat.shape, generator=gen)
    keys = tfs.client_keys(17, 3, torch.arange(C))
    specs = model.mask_specs([(B,) + tuple(sim.train_data[k].shape[1:]) for k in names],
                             model.dropout_rates)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in sim.train_data.items()}
        labels = local.labels_of(data, data_name)
        rows = idx.to(dev)
        masks = local.step_masks(keys.to(dev), specs)
        step = local.build_step_grad(model, data_name, template)
        grads, loss = step(flat.to(dev), tuple(data[k][rows] for k in names), labels[rows],
                           torch.ones((C, B), device=dev),
                           *(() if masks is None else (masks,)))
        out[dev] = (grads.cpu(), loss.cpu(), None if masks is None else [m.cpu() for m in masks])
    (g_card, l_card, m_card), (g_cpu, l_cpu, m_cpu) = out["cuda"], out["cpu"]
    same_masks = m_card is None or all(torch.equal(a, b) for a, b in zip(m_card, m_cpu))
    scale = float(g_cpu.abs().max())
    g_err, l_err = float((g_card - g_cpu).abs().max()), float((l_card - l_cpu).abs().max())
    l_tol = STEP_LOSS_TOL * max(1.0, float(l_cpu.abs().max()))
    log(f"[models] {label}: one step C={C} B={B} card vs CPU: K3 masks equal to the CPU's "
        f"{same_masks} ({len(specs)} tensors), max |d grad| {g_err:.3e} = {g_err / scale:.3e} of "
        f"max |g| {scale:.3e} (tol {STEP_GRAD_RTOL}), max |d loss| {l_err:.3e} of losses up to "
        f"{float(l_cpu.abs().max()):.4f} (tol {l_tol:.3e})")
    if not (same_masks and g_err <= STEP_GRAD_RTOL * scale and l_err <= l_tol):
        raise AssertionError(f"{label}: the card's step differs from the CPU's")


def resnet_vmap_vs_loop(sim: Simulator, params: dict) -> None:
    """A ResNet18 step's per-client gradients at config 5's C and B: one
    ``vmap(grad)`` over clients (per-client weights as a grouped conv),
    against a Python loop of ``grad`` over the clients, CUDA events."""
    cfg, model = sim.cfg, sim.model
    C, B = cfg.total_clients, cfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(0, sim.train_data["label"].shape[0], (C, B), generator=gen,
                        device="cuda")
    x, y = sim.train_data["x"][idx], local.labels_of(sim.train_data, "CIFAR10")[idx]
    mask = torch.ones((C, B), device="cuda")
    flat = tree_ravel_stacked(tree_broadcast(params, C)).contiguous()
    step = local.build_step_grad(model, "CIFAR10", params)
    loss_fn, unravel = local.make_loss_fn(model, "CIFAR10"), unraveler(params)
    one = torch.func.grad_and_value(
        lambda row, xc, yc, mc: loss_fn(unravel(row), (xc,), yc, mc))
    vmap_ms = time_ms(lambda: step(flat, (x,), y, mask), warmup=1, reps=3)
    loop_ms = time_ms(lambda: [one(flat[c], x[c], y[c], mask[c]) for c in range(C)],
                      warmup=1, reps=3)
    log(f"[models] config 5 step gradients C={C} B={B} (CUDA events, host time included): "
        f"vmap(grad) {vmap_ms:.3f} ms, a loop of grad over the clients {loop_ms:.3f} ms")


def model_run(label: str, config: dict, cut: dict, card: str) -> tuple[Simulator, dict]:
    """One model's run on the card: every round but the last through
    ``Simulator.run``, the last under torch.profiler; K3 launches counted
    over the whole run.  Gates: every round ok with a finite metric, the
    last above chance (CHANCE), the params finite, one K3 launch per
    minibatch step (none for ResNet18)."""
    cfg = Config(**{**config, **cut})
    for key in cut:
        log(f"[models] {label} reduced {key}: {config[key]} -> {cut[key]}")
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfs.run_epoch.launches = tfs.fill_masks.launches = 0
    state, history = sim.run(num_rounds=cfg.num_round - 1, state=state,
                             save_checkpoints=False, verbose=False)
    k3_before = tfs.fill_masks.launches
    state, metrics, prof = round_profile(sim, state)
    history.append(metrics)
    k3, k1 = tfs.fill_masks.launches, tfs.run_epoch.launches
    peak = torch.cuda.max_memory_allocated()
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    per_round = cfg.epochs * nb if sim.model.dropout_rates else 0
    metric = "roc_auc" if cfg.data_name == "ICU" else "accuracy"
    for h in history:
        extra = f" nll={h['nll']:.4f}" if "nll" in h else ""
        log(f"[models] {label} round {h['round']} ok={h['ok']} "
            f"{metric}={h.get(metric, float('nan')):.4f}"
            f"{extra} train_loss={h['train_loss']:.4f} seconds={h['seconds']:.4f}")
    k3_round = k3 - k3_before
    log(f"[models] {label} ({card}): s/round {[round(h['seconds'], 4) for h in history]} (the "
        f"last under torch.profiler); device busy {prof['busy_s']:.4f} s of that round's "
        f"{prof['wall_s']:.4f} s, idle share {1 - prof['busy_s'] / prof['wall_s']:.3f}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB; K3 {k3_round} launches in the round, "
        f"{prof['k3_us'] / max(k3_round, 1):.3f} us per step-launch, {k3} over "
        f"{len(history)} rounds")
    values = [h.get(metric, float("nan")) for h in history]
    if not all(h["ok"] for h in history) or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: a round failed or its {metric} is not finite")
    if CHANCE[label] is not None and not values[-1] > CHANCE[label]:
        raise AssertionError(f"{label}: {metric} {values[-1]} is not above chance "
                             f"{CHANCE[label]:.4f} by round {len(history)}")
    if "nll" in metrics and not math.isfinite(metrics["nll"]):
        raise AssertionError(f"{label}: NLL {metrics['nll']} is not finite")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["global_params"])):
        raise AssertionError(f"{label}: global params are not finite")
    if k1 != 0 or k3 != per_round * len(history) or k3_round != per_round:
        raise AssertionError(f"{label}: K1 {k1}, K3 {k3} launches ({k3_round} in the last "
                             f"round), expected {per_round} a round")
    return sim, state


def full_depth_round(config: dict, card: str) -> None:
    """One round of config 1 at full depth (12000-15000 samples a client,
    5 epochs: the config.yaml shape), timed by the host clock; K3 launches
    one per step."""
    cfg = Config(**{**config, "num_round": 1})
    log(f"[models] config 1 at full depth: num_data_range {cfg.num_data_range}, epochs "
        f"{cfg.epochs}, 1 of {config['num_round']} rounds")
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    torch.cuda.synchronize()
    tfs.fill_masks.launches = 0
    state, metrics = sim.run_round(state)
    steps = cfg.epochs * -(-cfg.num_data_range[1] // cfg.batch_size)
    log(f"[models] config 1 at full depth ({card}): one round ok={metrics['ok']} in "
        f"{metrics['seconds']:.3f} s, roc_auc {metrics.get('roc_auc', float('nan')):.4f}; K3 "
        f"{tfs.fill_masks.launches} launches ({steps} steps)")
    if not metrics["ok"] or tfs.fill_masks.launches != steps:
        raise AssertionError("config 1 at full depth: the round failed or K3 was not "
                             "launched once a step")


def models_phase(card: str) -> None:
    """Phase 9: each run of MODEL_RUNS, its step on the card against the
    CPU from the run's last params (at its init ResNet18's gradients are
    ill-conditioned in float32: on the CPU alone float32 and float64 part
    by 5.9e-4 of the largest |g|, in the convs' kernels), config 1's round
    at full depth, and config 5's vmap-vs-loop step; each part's
    seconds."""
    for label, config, cut in MODEL_RUNS:
        t0 = time.perf_counter()
        sim, state = model_run(label, config, cut, card)
        t1 = time.perf_counter()
        C, B = STEP_SHAPE.get(label, (config["total_clients"], config["batch_size"]))
        step_on_card_and_cpu(label, sim, state["global_params"], C, B)
        t2 = time.perf_counter()
        if config["model"] == "ResNet18":
            resnet_vmap_vs_loop(sim, state["global_params"])
        log(f"[models] {label}: run {t1 - t0:.1f} s (construction included), step on the "
            f"card and the CPU {t2 - t1:.1f} s, the rest {time.perf_counter() - t2:.1f} s")
        del sim, state
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full_depth_round(MODEL_RUNS[0][1], card)
    log(f"[models] config 1 at full depth: {time.perf_counter() - t0:.1f} s (construction "
        f"included)")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (b on the CPU)."""
    return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def hyper_updates_on_card_and_cpu(label: str, cfg: Config, hnet, flat: torch.Tensor,
                                  opt_state: dict, modes=("sequential", "batched")) -> None:
    """From the same warm state (``flat``, ``opt_state`` on the card): one
    ``generate_all``, then one update in each of ``modes`` on the same
    client rows (the generated rows plus a seeded 0.05, client 1
    inactive), on the card, on the CPU and on the CPU in float64: the
    hypernetwork within HYPER_RTOL of its largest magnitude, Adam's count
    equal, and m and v as close to float64 as MV_SPREAD times the CPU's
    float32 (their trunk entries are sums over P products, whose float32
    rounding depends on the summation order: the CPU's is the coarser)."""
    cpu_flat = flat.cpu()
    cpu_state = {k: v.cpu() for k, v in opt_state.items()}
    rows_card, emb_card = hnet.generate(flat)
    rows_cpu, emb_cpu = hnet.generate(cpu_flat)
    gen_err = rel_err(rows_card, rows_cpu)
    # clients' rows a local update away (~0.05) from the generated ones
    rows = rows_cpu + 0.05 * torch.randn(rows_cpu.shape,
                                         generator=torch.Generator().manual_seed(9))
    active = torch.ones(hnet.n_nodes)
    active[1] = 0.0
    wide = {k: (v.double() if v.is_floating_point() else v) for k, v in cpu_state.items()}
    errs, bad = {}, gen_err > HYPER_RTOL or not torch.equal(emb_card.cpu(), emb_cpu)
    for mode in modes:
        update, _ = build_hyper_update(cfg.replace(hyper_update_mode=mode), hnet)
        p_card, s_card = update(flat, opt_state, hnet.unravel_target(rows.cuda()), active.cuda())
        p_cpu, s_cpu = update(cpu_flat, cpu_state, hnet.unravel_target(rows), active)
        p64, s64 = update(cpu_flat.double(), wide, hnet.unravel_target(rows.double()), active)
        mv = {k: (rel_err(s_card[k], s64[k]), rel_err(s_cpu[k], s64[k])) for k in ("m", "v")}
        errs[mode] = (rel_err(p_card, p_cpu), mv, int(s_card["count"]), int(s_cpu["count"]),
                      rel_err(p_card, p64), rel_err(p_cpu, p64))
        bad = bad or errs[mode][0] > HYPER_RTOL or errs[mode][2] != errs[mode][3] or any(
            card > MV_SPREAD * cpu for card, cpu in mv.values())
    log(f"[hyper] {label}: card vs CPU from a warm state (Adam count {int(opt_state['count'])}):"
        f" generate_all {gen_err:.3e} of the largest |param|, embeddings equal "
        f"{torch.equal(emb_card.cpu(), emb_cpu)}; " + "; ".join(
            f"{m} update: params {e[0]:.3e} (tol {HYPER_RTOL}; from float64 card {e[4]:.3e}, "
            f"CPU float32 {e[5]:.3e}), count {e[2]}/{e[3]}, m and v "
            f"from float64 card {e[1]['m'][0]:.3e} {e[1]['v'][0]:.3e}, CPU float32 "
            f"{e[1]['m'][1]:.3e} {e[1]['v'][1]:.3e}" for m, e in errs.items()))
    if bad:
        raise AssertionError(f"{label}: the card's hypernetwork disagrees with the CPU's")


def detector_on_card_and_cpu(cfg: Config) -> None:
    """TransformerModel's hypernetwork at DETECT_C clients: per round one
    sequential update on the card and on the CPU from the same state (the
    CPU's), on seeded client rows (clients 0 and 1 far off), each
    device's embeddings into its own numpy detector (``cfg``'s, which
    acts from round 2): params within HYPER_RTOL, the removals and the
    DBSCAN phase's outliers equal."""
    tmpl = TransformerModel().init(torch.Generator().manual_seed(0))
    hnet = make_hypernetwork("HyperNetwork", tmpl, DETECT_C)
    # a larger step than the runs' hyper_lr, so the embeddings move apart
    # and the detector has decisions to make
    cfg = cfg.replace(hyper_update_mode="sequential", hyper_lr=DETECT_LR)
    update, opt = build_hyper_update(cfg, hnet)
    gen = torch.Generator().manual_seed(4)
    flat = hnet.init(torch.Generator().manual_seed(1))
    state = opt.init(flat)
    active = torch.ones(DETECT_C)
    hd = cfg.hyper_detection
    detectors = [defenses.HyperDetector(DETECT_C, hd.cosine_search, hd.n_components, hd.eps,
                                        hd.min_samples, hd.start_round, save_path=None)
                 for _ in range(2)]
    found, clients = [], list(range(DETECT_C))
    for r in range(DETECT_ROUNDS + 1):
        rows = hnet.generate(flat)[0]
        rows = rows + 0.05 * torch.randn(rows.shape, generator=gen)
        rows[:2] += 0.5 * torch.randn((2, rows.shape[1]), generator=gen)
        stacked = hnet.unravel_target(rows)
        if r == 0:                      # warm Adam up on the CPU first
            flat, state = update(flat, state, stacked, active)
            continue
        p_card, s_card = update(flat.cuda(), {k: v.cuda() if v.ndim else v
                                              for k, v in state.items()},
                                hnet.unravel_target(rows.cuda()), active.cuda())
        flat, state = update(flat, state, stacked, active)
        err = rel_err(p_card, flat)
        embs = [hnet.generate(p)[1].detach().cpu().numpy() for p in (p_card, flat)]
        t0 = time.perf_counter()
        removed = [det.observe(r, clients, e) for det, e in zip(detectors, embs)]
        host_ms = (time.perf_counter() - t0) * 1e3 / 2
        # the DBSCAN phase alone, on each device's embedding deltas
        outliers = [defenses.dbscan_outlier_clients(
            np.stack([det.history[c][-2] for c in clients]),
            np.stack([det.history[c][-1] for c in clients]),
            clients, hd.n_components, hd.eps, hd.min_samples) if r >= 2 else []
            for det in detectors]
        found.append((err, removed, outliers, int(s_card["count"]), int(state["count"]),
                      host_ms))
    log(f"[hyper] detector at C={DETECT_C} (TransformerModel's hypernetwork), per round: "
        + "; ".join(f"round {i + 1}: params {e:.3e}, removals card {rc} CPU {rp}, DBSCAN "
                    f"outliers card {oc} CPU {op}, counts {cc}/{cp}, detector {ms:.3f} ms "
                    f"(host)" for i, (e, (rc, rp), (oc, op), cc, cp, ms) in enumerate(found)))
    if any(e > HYPER_RTOL or rc != rp or oc != op or cc != cp
           for e, (rc, rp), (oc, op), cc, cp, _ in found):
        raise AssertionError("the detector's decisions or the update on the card disagree "
                             "with the CPU's")


def hyper_run(label: str, config: dict, cut: dict, card: str, workdir: str
              ) -> tuple[Simulator, dict]:
    """One hyper run on the card, as ``model_run``: every round but the
    last through ``Simulator.run``, the last under torch.profiler; the
    detector's calls timed on the host.  Gates: every round ok with a
    finite metric, config 2's last AUC above 0.5, the hypernetwork finite,
    one K3 launch per minibatch step (none for ResNet18).  Then the
    device ms of generate_all, the update and the hyper validation."""
    cfg = Config(**{**config, **cut, "log_path": workdir, "checkpoint_dir": workdir})
    for key in cut:
        log(f"[hyper] {label} reduced {key}: {config[key]} -> {cut[key]}")
    t0 = time.perf_counter()
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    detect = []
    restore = (timed_calls(sim.detector, "observe", detect, host=True)
               if sim.detector is not None else (lambda: None))
    torch.cuda.reset_peak_memory_stats()
    tfs.run_epoch.launches = tfs.fill_masks.launches = 0
    try:
        state, history = sim.run(num_rounds=cfg.num_round - 1, state=state,
                                 save_checkpoints=False, verbose=False)
        k3_before = tfs.fill_masks.launches
        state, metrics, prof = round_profile(sim, state)
    finally:
        restore()
    history.append(metrics)
    k3, k1 = tfs.fill_masks.launches, tfs.run_epoch.launches
    peak = torch.cuda.max_memory_allocated()
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    per_round = cfg.epochs * nb if sim.model.dropout_rates else 0
    metric = "roc_auc" if cfg.data_name == "ICU" else "accuracy"
    for h in history:
        extra = f" nll={h['nll']:.4f}" if "nll" in h else ""
        log(f"[hyper] {label} round {h['round']} ok={h['ok']} "
            f"{metric}={h.get(metric, float('nan')):.4f}{extra} "
            f"train_loss={h['train_loss']:.4f} removed={h.get('removed_clients', [])} "
            f"seconds={h['seconds']:.4f}")
    k3_round = k3 - k3_before
    log(f"[hyper] {label} ({card}): hypernetwork {sim.hnet.numel:,} floats; set-up "
        f"{setup:.3f} s; s/round {[round(h['seconds'], 4) for h in history]} (the last under "
        f"torch.profiler); device busy {prof['busy_s']:.4f} s of that round's "
        f"{prof['wall_s']:.4f} s, idle share {1 - prof['busy_s'] / prof['wall_s']:.3f}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB; K3 {k3_round} launches in the round, "
        f"{prof['k3_us'] / max(k3_round, 1):.3f} us per step-launch, {k3} over "
        f"{len(history)} rounds")
    if detect:
        log(f"[hyper] {label}: detector host ms per round "
            f"{[round(t * 1e3, 3) for t, _ in detect]}; removals "
            f"{[h.get('removed_clients', []) for h in history]}; active clients at the end "
            f"{int(state['active_mask'].sum())}")
    values = [h.get(metric, float("nan")) for h in history]
    if not all(h["ok"] for h in history) or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: a round failed or its {metric} is not finite")
    if label == "config 2" and not values[-1] > 0.5:
        raise AssertionError(f"{label}: ROC-AUC {values[-1]} is not above 0.5")
    if "nll" in metrics and not math.isfinite(metrics["nll"]):
        raise AssertionError(f"{label}: NLL {metrics['nll']} is not finite")
    if not bool(torch.isfinite(state["hnet_params"]).all()):
        raise AssertionError(f"{label}: the hypernetwork is not finite")
    if k1 != 0 or k3 != per_round * len(history) or k3_round != per_round:
        raise AssertionError(f"{label}: K1 {k1}, K3 {k3} launches ({k3_round} in the last "
                             f"round), expected {per_round} a round")

    # the phases by CUDA events, from the run's last state
    flat, opt = state["hnet_params"], state["hyper_opt_state"]
    reps = 3 if cfg.model == "ResNet18" else 7
    gen_ms = time_ms(lambda: sim.hnet.generate_all(flat), warmup=1, reps=reps)
    gen, _ = sim.hnet.generate_all(flat)
    rows = sim.hnet.unravel_target(sim.hnet.generate(flat)[0] + 1e-3)
    mask = state["active_mask"].cuda()
    upd_ms = time_ms(lambda: sim.hyper_update(flat, opt, rows, mask), warmup=1, reps=reps)
    ids = torch.nonzero(mask > 0)[:, 0]
    val_ms = time_ms(lambda: sim.validation.test_hyper(tree_take(gen, ids)), warmup=1, reps=3)
    log(f"[hyper] {label} ({card}, CUDA events, host time included): generate_all "
        f"{gen_ms:.3f} ms, hyper_update[{cfg.hyper_update_mode}] {upd_ms:.3f} ms, hyper "
        f"validation ({int(mask.sum())} clients x {cfg.test_size} rows) {val_ms:.3f} ms")
    return sim, state


def batched_update_memory(sim: Simulator, state: dict) -> None:
    """A batched update of the run's hypernetwork (ResNet18's): the memory
    it adds at its peak stays under what C gradients and the three
    clones would take, (3 + C) x its size."""
    hnet = sim.hnet
    update, _ = build_hyper_update(sim.cfg.replace(hyper_update_mode="batched"), hnet)
    rows = hnet.unravel_target(hnet.generate(state["hnet_params"])[0] + 1e-3)
    mask = torch.ones(hnet.n_nodes, device=state["hnet_params"].device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = update(state["hnet_params"], state["hyper_opt_state"], rows, mask)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    size = hnet.numel * 4
    del out
    log(f"[hyper] ResNet18 batched update at C={hnet.n_nodes}: peak added "
        f"{added / 2 ** 30:.3f} GiB = {added / size:.2f} x the hypernetwork "
        f"({size / 2 ** 30:.3f} GiB); C gradients and the clones would be "
        f"{3 + hnet.n_nodes} x")
    if added >= (3 + hnet.n_nodes) * size:
        raise AssertionError("the batched update holds a gradient per client")


def spec_norm_memory(sim: Simulator, state: dict) -> None:
    """ResNet18's hypernetwork with spectral normalization, from the run's
    last state: one generate_all and one batched update on the card, twice
    (the first call builds the heads' ``Segments``), each timed, their
    peak memory, and the outputs finite with Adam's count one up."""
    hnet = make_hypernetwork("HyperNetwork", sim.target_template, sim.cfg.total_clients,
                             spec_norm=True)
    update, _ = build_hyper_update(sim.cfg.replace(hyper_update_mode="batched"), hnet)
    flat, opt = state["hnet_params"], state["hyper_opt_state"]
    mask = torch.ones(hnet.n_nodes, device=flat.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, finite = [], True
    for _ in range(2):
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        rows, _ = hnet.generate(flat)
        mid.record()
        p, s = update(flat, opt, hnet.unravel_target(rows + 1e-3), mask)
        end.record()
        torch.cuda.synchronize()
        times.append((start.elapsed_time(mid), mid.elapsed_time(end)))
        finite = (finite and bool(torch.isfinite(p).all())
                  and int(s["count"]) == int(opt["count"]) + 1)
        del p, s, rows
    peak = torch.cuda.max_memory_allocated()
    log(f"[hyper] ResNet18 with spectral norm at C={hnet.n_nodes} (CUDA events, host "
        f"included): generation then batched update, first call "
        f"{times[0][0]:.3f} + {times[0][1]:.3f} ms, second {times[1][0]:.3f} + "
        f"{times[1][1]:.3f} ms; peak memory {peak / 2 ** 30:.3f} GiB ({base / 2 ** 30:.3f} "
        f"GiB held before); finite with Adam's count one up {finite}")
    if not finite:
        raise AssertionError("ResNet18's spectrally normalized update is not finite")


def hyper_phase(card: str) -> None:
    """Phase 10: each run of HYPER_RUNS (in a temporary log directory: the
    detector saves its embeddings there), the card against the CPU on
    config 2's and CNNHyper's last states, the detector check and the
    batched update's memory at ResNet18's size, with and without spectral
    normalization."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_hyper_")
    try:
        for label, config, cut in HYPER_RUNS:
            t0 = time.perf_counter()
            sim, state = hyper_run(label, config, cut, card, workdir)
            t1 = time.perf_counter()
            if label == "config 2":
                hyper_updates_on_card_and_cpu(label, sim.cfg, sim.hnet, state["hnet_params"],
                                              state["hyper_opt_state"])
            if label == "CNNHyper":
                hyper_updates_on_card_and_cpu(label, sim.cfg, sim.hnet, state["hnet_params"],
                                              state["hyper_opt_state"])
            if label == "config 4 hyper":
                detector_on_card_and_cpu(sim.cfg)
            if config["model"] == "ResNet18":
                batched_update_memory(sim, state)
                spec_norm_memory(sim, state)
            log(f"[hyper] {label}: run {t1 - t0:.1f} s (construction included), checks "
                f"{time.perf_counter() - t1:.1f} s")
            del sim, state
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir)


def launch_counts() -> dict:
    return {"fused_step": tfs.run_epoch.launches, "dropout_mask": tfs.fill_masks.launches}


def reset_launches() -> None:
    torch.cuda.synchronize()
    tfs.run_epoch.launches = tfs.fill_masks.launches = 0


def require_kernel(label: str, cfg: Config, launches: dict, broadcasts: int) -> None:
    """K1 under pallas (epochs a broadcast), K3 once per minibatch step
    under xla."""
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    expect = ({"fused_step": broadcasts * cfg.epochs, "dropout_mask": 0}
              if cfg.local_backend == "pallas" else
              {"fused_step": 0, "dropout_mask": broadcasts * cfg.epochs * nb})
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expect}")


def cohort_rows_check(sim: Simulator, label: str) -> None:
    """Broadcast 3's round step: the forced cohort's rows are the params
    it was broadcast, bit for bit, with size 0."""
    state = sim.init_state()
    draws = sim.draw_round(torch.Generator(device=sim.device).manual_seed(11))
    stacked, sizes = sim.round_step(state["global_params"], state["prev_genuine"], False,
                                    draws, 3)[:2]
    cohort = list(FAULT_COHORT)
    for (path, rows), (_, p) in zip(tree_items(stacked), tree_items(state["global_params"])):
        if not torch.equal(rows[cohort], p.expand((len(cohort),) + tuple(p.shape))):
            raise AssertionError(f"{label}: a forced-dropout client's {path} moved")
    if sizes[cohort].any() or not sizes.any():
        raise AssertionError(f"{label}: the cohort's sizes {sizes[cohort].tolist()}")
    log(f"[faults] {label}: broadcast 3's round step: cohort {cohort} reports the broadcast "
        "params bit for bit, sizes 0")


def fault_run(backend: str, root: str) -> list:
    """Run a: config 4 (cut) with FAULT_PLAN, saving every round; then 2
    rounds into another directory and a resumed Simulator for round 3.
    Returns the synchronous saves' host seconds."""
    plan = parse_fault_plan(FAULT_PLAN)
    whole_dir, cut_dir = os.path.join(root, backend, "whole"), os.path.join(root, backend, "cut")
    sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=whole_dir, faults=plan),
                    device="cuda")
    cohort_rows_check(sim, backend)
    saves = []
    save = sim.save_checkpoint

    def timed_save(state, save=save):
        t0 = time.perf_counter()
        written = save(state)
        saves.append(time.perf_counter() - t0)
        return written

    sim.save_checkpoint = timed_save
    state = sim.init_state()
    reset_launches()
    whole, history = sim.run(state=state, verbose=False)
    launches = launch_counts()
    seq = [(h["broadcast"], h["ok"]) for h in history]
    records = [(r["fault"], r["round"]) for r in sim.fault_injector.records]
    rounds = [e["round"] for e in sim.checkpoints.read_manifest()["entries"]]
    log(f"[faults] {backend}: broadcasts (number, ok) {seq}; AUC "
        f"{[round(h.get('roc_auc', float('nan')), 4) for h in history]}; injected {records}; "
        f"manifest rounds {rounds}; launches {launches}; sync saves "
        f"{[round(t, 4) for t in saves]} s (the first with two retries' backoff)")
    if seq != [(1, True), (2, False), (3, True), (4, True)]:
        raise AssertionError(f"{backend}: the faulted run's broadcasts {seq}")
    if records[:2] != [("ckpt_write_error", 1)] * 2 or rounds != [1, 2, 3]:
        raise AssertionError(f"{backend}: the first save did not retry through two failures")
    require_kernel(f"{backend} faults", sim.cfg, launches, len(history))

    Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir, faults=plan),
              device="cuda").run(num_rounds=2, verbose=False)
    resumed_sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir,
                                       faults=plan, resume=True), device="cuda")
    state = resumed_sim.load_or_init_state()
    reset_launches()
    resumed, rest = resumed_sim.run(state=state, verbose=False)
    launches = launch_counts()
    gap = max_param_gap(resumed["global_params"], whole["global_params"])
    log(f"[faults] {backend}: resume from round {state['completed_rounds']} (the round-2 entry "
        f"torn); resumed broadcasts {[(h['broadcast'], h['ok']) for h in rest]}; resumed vs "
        f"uninterrupted max |d params| {gap:.3e} (two runs without a stop: "
        f"{RUN_GAPS[backend]:.3e}); launches {launches}")
    if state["completed_rounds"] != 1 or [h["round"] for h in rest if h["ok"]] != [2, 3]:
        raise AssertionError(f"{backend}: the resume did not fall back past the torn entry")
    if gap > RUN_GAPS[backend]:
        raise AssertionError(f"{backend}: the resumed run left the uninterrupted one")
    require_kernel(f"{backend} resumed", resumed_sim.cfg, launches, len(rest))
    return saves


def hyper_fault_run(workdir: str) -> None:
    """Run b: hyper config 2 (cut) with a NaN storm at broadcast 2: the
    broadcast fails, the hypernetwork and Adam's state stay, the retry
    is ok."""
    label, config, cut = HYPER_RUNS[0]
    cfg = Config(**{**config, **cut, "log_path": workdir, "checkpoint_dir": workdir,
                    "faults": parse_fault_plan("nan_storm@2")})
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    reset_launches()
    seq = []
    while state["completed_rounds"] < cfg.num_round:
        before = (state["hnet_params"], state["hyper_opt_state"])
        state, metrics = sim.run_round(state)
        seq.append((metrics["broadcast"], metrics["ok"]))
        if not metrics["ok"] and not (
                torch.equal(state["hnet_params"], before[0])
                and all(torch.equal(state["hyper_opt_state"][k], before[1][k])
                        for k in ("m", "v", "count"))):
            raise AssertionError("hyper: the stormed broadcast moved the hypernetwork")
    launches = launch_counts()
    log(f"[faults] hyper {label}: broadcasts (number, ok) {seq}; the stormed broadcast kept "
        f"the hypernetwork and Adam's state bit for bit; launches {launches}")
    if seq != [(1, True), (2, False), (3, True), (4, True)]:
        raise AssertionError(f"hyper: broadcasts {seq}")
    require_kernel("hyper faults", cfg, launches, len(seq))


def async_run(root: str, sync_saves: list) -> None:
    """Run c: config 4 (cut) under pallas with the async writer, async
    validation and a killed writer thread before round 2's submit."""
    cfg = cut_config(local_backend="pallas", checkpoint_dir=os.path.join(root, "async"),
                     checkpoint_async=True, validation_async=True,
                     faults=parse_fault_plan("writer_death@2"))
    sim = Simulator(cfg, device="cuda")
    submits = []
    save = sim.save_checkpoint

    def timed_save(state, save=save):
        t0 = time.perf_counter()
        written = save(state)
        submits.append(time.perf_counter() - t0)
        return written

    sim.save_checkpoint = timed_save
    state = sim.init_state()
    reset_launches()
    t0 = time.perf_counter()
    state, history = sim.run(state=state, verbose=False)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    writer = sim.checkpoint_writer
    sim.close()
    sync = MAIN_HISTORY["pallas"]
    gap = max_param_gap(state["global_params"], MAIN_STATES["pallas"]["global_params"])
    aucs = [h["roc_auc"] for h in history]
    entry = sim.checkpoints.read_manifest()["entries"][-1]
    loaded = ckpt.load_state(os.path.join(sim.checkpoints.directory, entry["file"]),
                             sim.host_state(sim.init_state()))
    loaded_gap = max_param_gap(tree_map(lambda x: x.cuda(), loaded["global_params"]),
                               MAIN_STATES["pallas"]["global_params"])
    log(f"[async] pallas, async writer + async validation + writer_death@2: "
        f"{len(history)} rounds ok={[h['ok'] for h in history]} in {run_s:.3f} s; AUC {aucs} "
        f"(sync {[h['roc_auc'] for h in sync]}); validation_ok "
        f"{[h['validation_ok'] for h in history]}; max |d params| from the sync run {gap:.3e} "
        f"(two runs without a stop: {RUN_GAPS['pallas']:.3e}); writer restarts "
        f"{writer.restarts}, writes {writer.writes_completed}, coalesced "
        f"{writer.writes_coalesced}; newest entry round {entry['round']} loads within "
        f"{loaded_gap:.3e}; launches {launches}")
    log(f"[async] the round loop's cost of a save (host clock, {card_line()}): async submit "
        f"{[round(t * 1e3, 3) for t in submits]} ms (the copy to the host included) against "
        f"the synchronous save's {[round(t * 1e3, 3) for t in sync_saves]} ms in run a "
        "(the first with two retries' backoff)")
    if not all(h["ok"] and h["validation_ok"] for h in history) or len(history) != 3:
        raise AssertionError("async: a round or its validation failed")
    if gap > RUN_GAPS["pallas"] or loaded_gap > RUN_GAPS["pallas"]:
        raise AssertionError("async: the params differ from the synchronous run's")
    if gap == 0.0 and aucs != [h["roc_auc"] for h in sync]:
        raise AssertionError("async: the AUCs differ from the synchronous run's")
    if writer.restarts != 1 or entry["round"] != 3:
        raise AssertionError(f"async: writer restarts {writer.restarts}, newest entry "
                             f"{entry['round']}")
    require_kernel("async", cfg, launches, len(history))


def bf16_family(workdir: str) -> None:
    """Run d: BF16_FAMILY in float32, then in bfloat16."""
    finals, trajectories = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(**BF16_FAMILY, mesh=MeshConfig(compute_dtype=dtype), log_path=workdir,
                     checkpoint_dir=workdir)
        sim = Simulator(cfg, device="cuda")
        state = sim.init_state()
        reset_launches()
        t0 = time.perf_counter()
        state, history = sim.run(state=state, save_checkpoints=False, verbose=False)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        trajectories[dtype] = [h["roc_auc"] for h in history]
        finals[dtype] = trajectories[dtype][-1]
        log(f"[bf16] family {dtype}: {len(history)} rounds in {seconds:.3f} s, all ok "
            f"{all(h['ok'] for h in history)}; AUC {[round(a, 4) for a in trajectories[dtype]]}; "
            f"launches {launches}")
        if not all(h["ok"] for h in history) or len(history) != cfg.num_round:
            raise AssertionError(f"bf16 family {dtype}: a round failed")
        if not abs(finals[dtype] - BF16_ARTIFACT_AUC) <= BF16_AUC_TOL:
            raise AssertionError(f"bf16 family {dtype}: final AUC {finals[dtype]:.4f} is not "
                                 f"within {BF16_AUC_TOL} of {BF16_ARTIFACT_AUC}")
        require_kernel(f"bf16 family {dtype}", cfg, launches, len(history))
    diff = abs(finals["bfloat16"] - finals["float32"])
    per_round = max(abs(a - b) for a, b in zip(*trajectories.values()))
    log(f"[bf16] family: final AUC float32 {finals['float32']:.4f}, bfloat16 "
        f"{finals['bfloat16']:.4f} (the artifact's {BF16_ARTIFACT_AUC} in both), |d| "
        f"{diff:.4f} (tol {BF16_F32_TOL}); largest per-round |d AUC| {per_round:.4f} (the "
        "artifact's 5e-4)")
    if diff > BF16_F32_TOL:
        raise AssertionError("bf16 family: bfloat16's final AUC left float32's")


def bf16_step_on_card_and_cpu() -> None:
    """One minibatch step of TransformerModel at config 4's shape (100
    clients, B = 128, its K3 masks) in float32 and in bfloat16 on the card
    and on the CPU: the card's bf16 distance from its float32 step within
    twice the CPU's plus 1e-6; the card's bf16 GEMM kernels bf16 ones
    (every product of TransformerModel is bfloat16, as in JAX's jaxpr:
    tests/test_torch_port_bf16.py)."""
    C, B = CONFIG4["total_clients"], CONFIG4["batch_size"]
    model = TransformerModel()
    params = model.init(torch.Generator().manual_seed(1))
    data = get_dataset("ICU", "train", 4096, 1)
    gen = torch.Generator().manual_seed(13)
    idx = torch.randint(0, 4096, (C, B), generator=gen)
    flat = tree_ravel_stacked(tree_broadcast(params, C))
    flat = flat + 1e-3 * torch.randn(flat.shape, generator=gen)
    keys = tfs.client_keys(17, 3, torch.arange(C))
    specs = model.mask_specs([(B, 7), (B, 16)], model.dropout_rates)
    grads, gemms = {}, []
    for dev in ("cuda", "cpu"):
        cols = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        labels = local.labels_of(cols, "ICU")
        rows = idx.to(dev)
        masks = local.step_masks(keys.to(dev), specs)
        batch = (tuple(cols[k][rows] for k in ("vitals", "labs")), labels[rows],
                 torch.ones((C, B), device=dev), masks)
        for dtype in (None, torch.bfloat16):
            step = local.build_step_grad(model, "ICU", params, dtype)
            if dev == "cuda" and dtype is not None:
                step(flat.to(dev), *batch)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    g, _ = step(flat.to(dev), *batch)
                    torch.cuda.synchronize()
                gemms = sorted({e.name for e in prof.events()
                                if e.device_type != DeviceType.CPU
                                and re.search(r"gemm|gemv|xmma|cutlass", e.name, re.I)})
            else:
                g, _ = step(flat.to(dev), *batch)
            grads[dev, dtype] = g.cpu()
    card = float((grads["cuda", torch.bfloat16] - grads["cuda", None]).abs().max())
    cpu = float((grads["cpu", torch.bfloat16] - grads["cpu", None]).abs().max())
    scale = float(grads["cpu", None].abs().max())
    not_bf16 = [n for n in gemms if not re.search(r"bf16|bfloat16", n, re.I)]
    log(f"[bf16] step C={C} B={B}: max |g_bf16 - g_f32| card {card:.3e}, CPU {cpu:.3e} "
        f"(max |g| {scale:.3e}; gate card <= 2 x CPU + 1e-6); the card's GEMM kernels "
        f"{[n[:90] for n in gemms]}; not bf16: {not_bf16}")
    if not card <= 2.0 * cpu + 1e-6:
        raise AssertionError("bf16 step: the card's bf16 step is further from float32 than "
                             "the CPU's")
    if not gemms or not_bf16:
        raise AssertionError(f"bf16 step: GEMM kernels that are not bf16: {not_bf16}")


def faults_dtypes_async_phase(card: str) -> None:
    """Phase 11: runs a-e."""
    root = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        t0 = time.perf_counter()
        saves = {backend: fault_run(backend, root) for backend in ("pallas", "xla")}
        t1 = time.perf_counter()
        hyper_fault_run(root)
        t2 = time.perf_counter()
        async_run(root, saves["pallas"])
        t3 = time.perf_counter()
        bf16_family(root)
        bf16_step_on_card_and_cpu()
        t4 = time.perf_counter()
        for label, config, cut in MODEL_RUNS[2:]:
            bf16 = dict(config, mesh=MeshConfig(compute_dtype="bfloat16"))
            sim, state = model_run(f"{label} bf16", bf16, cut, card)
            log(f"[bf16] {label}: float32 in PERF.md §5: {F32_ROWS[label]}; this call's "
                "float32 run is phase 9's")
            del sim, state
            torch.cuda.empty_cache()
        log(f"[phase 11] a {t1 - t0:.1f} s, b {t2 - t1:.1f} s, c {t3 - t2:.1f} s, d "
            f"{t4 - t3:.1f} s, e {time.perf_counter() - t4:.1f} s")
    finally:
        shutil.rmtree(root)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    started = time.perf_counter()
    card = card_line()
    log(f"[device] {card}")
    check_card(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    resolve_device("cuda")

    t0 = time.perf_counter()
    built = build.build_all(KERNELS)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in built[name][1].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
        build.load_library(name)

    check_validator()
    kernels = [check_fused_step(card, built["fused_step"][1]), check_dropout_mask()]
    xla_epoch_ms()
    launches, states = main_path()
    MAIN_STATES.update(states)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    for name, phase in (("checkpoints", lambda: checkpoint_phase(states)),
                        ("stragglers", straggler_phase), ("attacks", attack_phase),
                        ("defenses", defense_phase), ("models", lambda: models_phase(card)),
                        ("hyper", lambda: hyper_phase(card)),
                        ("faults, dtypes, async", lambda: faults_dtypes_async_phase(card))):
        t0 = time.perf_counter()
        phase()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[done] all phases in {time.perf_counter() - started:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
