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
                 (the same masks, gradients within 1e-4 of the largest,
                 or, where the two float32 steps fall on either side of
                 a ReLU's kink, within 1e-4 of float64 on the card's
                 side); config 5's step also from its initial state,
                 which takes that branch; config 1's round at full
                 depth; ResNet18's per-client gradients by vmap against
                 a loop over clients;
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
                 HAR classifier and config 5 (cut) in bfloat16;
 12. fused path and launch surface -- a. config 4 (cut) under each
                 backend through Simulator.run_fast(chunk_size=3): the
                 params of phase 4's run within the gap between two runs
                 without a stop, the rounds' AUC and loss BASELINE_ROUNDS,
                 K1 2 and K3 24 launches a round, s/round beside run's;
                 b. the host syncs (torch.cuda.set_sync_debug_mode("warn"))
                 of a run round and of a run_fast chunk at lengths 1 and 3
                 under each backend: a chunk makes SYNCS_PER_CHUNK at
                 both lengths; c. phase 11a's fault plan under
                 run_fast(chunk_size=1) with checkpoints: T, F, T, T, the
                 params of phase 11a's run, and a resume past the torn
                 entry ending on the uninterrupted run; d. hyper config 2
                 (cut) under run_fast: run's params bit for bit; e. three
                 `python -m attackfl_tpu_torch client` registrations (one
                 LIE attacker) and `server --rounds 1` on a copy of
                 config.yaml cut to 3 clients: exit 0, the registrations'
                 attackers, app.log's lines, K3 launched;
 13. pipelined executor -- a. config 4 (cut) under each backend through
                 Simulator.run(pipeline=True) at depths 0, 1, 2 and 4: the
                 params of phase 4's run within the gap between two runs
                 without a stop, its ok sequence and broadcasts, the rounds'
                 AUC and loss BASELINE_ROUNDS; s/round, dispatch and
                 resolve milliseconds a round; the host syncs of a depth-2
                 run (none besides the resolve's event waits); the device
                 idle share of a depth-0 and a depth-2 run under pallas;
                 b. phase 11a's fault plan at depth 2 under each backend
                 (phase 11a's ok sequence and params), and a plan failing
                 every client on broadcasts 2-4 at depth 3 with demotion
                 after 2 rollbacks and re-promotion after 2 clean rounds:
                 run's ok sequence and params, one demotion, one
                 re-promotion to depth 3; c. checkpoints at depth 2 with
                 the synchronous and the async writer: each entry run's
                 for its round, a resume continuing the numbering and
                 ending on the uninterrupted run, the syncs a round the
                 saves add; d. hyper config 2 (cut) at depth 2: run's
                 hypernetwork and Adam state bit for bit, its syncs a
                 round; e. a stop hook at one completed round: the rounds
                 in flight resolve and checkpoint, the verdict is kept;
                 f. `server --no-wait --pipeline-depth 2` on phase 12e's
                 cut of config.yaml: exit 0, K3 launched, app.log as the
                 pipelined executor writes it;
 14. telemetry and ledger -- a. config 4 (cut) through run, run_fast
                 (one chunk of 3) and run(pipeline=True) at depth 2 under
                 each backend, with telemetry off, on, on and off in
                 turns: every event
                 valid, the kinds in the JAX package's order, the params
                 equal bit for bit, the host syncs equal (a chunk 1, the
                 pipeline 0), telemetry off writing no file, s/round on
                 and off, and the run's end (the counters, run_end and
                 trace, the ledger append) timed on its own; a pallas
                 run of 20 rounds in the same turns; b. phase 11a's fault plan under run and its
                 resume: the fault, retry, checkpoint and resume events;
                 phase 13b's demotion plan: one demoted and one
                 repromoted degrade event; c. two rounds under each
                 defense with a verdict: the attacking round's
                 attribution event names its 25 attackers; d. a's
                 pipelined config under pipeline_depth auto, reading a's
                 ledger: the depth, the record's round_device_time and
                 host_resolution_latency beside the profiler's
                 device-busy s/round;
 15. numerics and monitor -- a. config 4 (cut) through run, run_fast
                 (one chunk of 3) and run(pipeline=True) at depth 2 under
                 each backend, with numerics off, on, on and off in turns
                 (the ring's window 2): the params equal bit for bit, one
                 valid numerics metric event a round in round order, the
                 host syncs (a chunk 1, the pipeline 0, run one more a
                 drain), s/round on and off, the drain's ms; the numerics
                 step's launches, device-busy ms and host ms on a round's
                 inputs; b. that round's row on the card against
                 compute_row on the CPU from the same inputs (gauges within
                 NUMERICS_RTOL relative, the histogram equal unless a norm
                 lies within NUMERICS_RTOL of an edge); c. phase 11a's plan
                 with monitor_stall@3 and the monitor on: the storm round's
                 non-finite clients and first layer, /healthz 503 right
                 after the stall with one stall event, 200 after the next
                 round; d. phase 13b's demotion plan with the monitor on:
                 /metrics' attackfl_pipeline_depth 3, 0, 3, /last-round's
                 numerics gauges, `python -m attackfl_tpu_torch watch
                 --once` and `metrics --numerics` on a's events; the
                 monitor's host ms a round; e. hyper config 2 (cut) with
                 numerics on and off: one row a round, the hypernetwork
                 and Adam state bit for bit.
 16. hotspot windows and the cost model -- see hotspots_phase;
 17. scenario matrix -- a. the sweep of LIE (z 0.74, from round 2) and
                 none x fedavg, krum, median, FLTrust, gmm and hyper x
                 seeds 1 and 2 on config 4 (cut, one epoch, 300-375
                 samples a client) under xla, 2
                 rounds in a chunk of 2 (12 batched, 4 mapped, 4 host, 4
                 special cells; the 16 device cells' clients trained in
                 one folded local update a broadcast, 1,600 rows): every
                 device cell's final state against run_fast of its
                 cell_config and one gmm and one
                 hyper cell against run, bit for bit, with the same ok
                 sequences; b. K3 at the folded shape against its plain
                 version bit for bit, its time beside its bound; its
                 launches over the device cells equal to the fold's
                 steps times its parts plus FLTrust's root steps; the
                 chunk's host syncs, one, FLTrust's cells' included;
                 c. the sweep stopped by its hook after the first
                 fallback cell and resumed: a's grid byte for byte, the
                 completed fallback cell running zero rounds; d. 24
                 ledger records sharing one sweep_id, the matrix and
                 science events valid, `matrix status` and `cost
                 estimate --matrix` exit 0; e. the device cells' sweep
                 round against the sum of their standalone rounds, the
                 folded update's host-issue and device-busy ms, the peak
                 memory, the fallback groups' seconds;
 18. audit, recompile guard, ledger and science -- a. each round
                 program of config 4 (cut) under each backend
                 (round_step, aggregate, fused_chunk[2],
                 pipeline_step[eval=True]) and the sweep's program on a
                 2 x 2 x 1 grid under xla, run once by the program audit
                 on the card: no host sync (the dispatch mode's and
                 set_sync_debug_mode's, with their sites), no float64
                 output, no input written in place, K1 or K3 launched
                 inside as many times as the program trains, its ms;
                 b. the recompile guard over run, run_fast (chunks of 3)
                 and the pipeline at depth 2 under each backend with the
                 cost model on: nothing built, captured or loaded after
                 the snapshot; c. two plain pallas runs and one with a
                 hotspot window over rounds 2-3 into one ledger, and a
                 copy of the first at half its rate: `ledger list`,
                 `show`, `compare`, `regress --against` the first, each
                 verdict agreeing with its records' rates against its
                 threshold, the halved copy's 1 naming rounds_per_sec;
                 d. two sweeps of LIE and none x
                 fedavg and median x seeds 1 and 2, 2 rounds: `ledger
                 list --sweep`, `regress --sweeps`, `science
                 leaderboard`, `report` and `diff --gate`, each exit 0;
                 e. `audit --json --device cuda --skip-grad` on the
                 tree: ok;
 19. transform-safety auditor -- a. the grad programs of audit_config()
                 (CNNModel, dropout on) for fedavg, median and FLTrust on
                 the card (grad_audit.audit_grad_programs): the six
                 first-order programs without sync (with their sites),
                 float64 output or input written, the gradient the
                 perturbation's tree, K3 launched as they train, their
                 ms and peak GiB; the three double-backward traces ok;
                 b. config 4 (cut) under xla, fedavg, from the attacking
                 state (a leak pool, broadcast attack_round - 1): the
                 gradients of sync_damage and fused_damage[2], each
                 value under the gradient equal to its value under
                 no_grad bit for bit, ms, peak GiB, K3 launches (24 and
                 48), non-finite entries and max |g|; against the same
                 inputs and draws on the CPU (sync within 1e-4 of max
                 |g|; fused the same non-finite entries, the finite ones
                 within 1e-4); c. the local update's out-of-place Adam
                 (local.adam_step) against the same step written in
                 place, bit for bit, at config 4's 100 rows and over 3
                 rounds of config 4 (cut) through run; d. FLTrust on
                 config 4 (cut): a run_fast chunk of 3 makes 1 host sync;
                 the root update with the drawn device seed against the
                 same update given int(seed), bit for bit; e. `audit
                 --json --device cuda` with the grad audit: ok, the
                 dataflow verdicts those of
                 tests/data/grad_audit_report.json.
 20. run service and scheduler -- config 4 (cut) jobs on RunService
                 daemons on the card (service_phase): a0. a pallas and an
                 xla job as a pair in two slots, their wall seconds against
                 their standalone runs'; a. J1 (pallas, low), J2 (xla,
                 normal), J4 (J1's config, high) and J3 (a 2 x 2 x 1
                 matrix, normal) in two slots under SERVICE_PLAN: J2's torn
                 status replayed, a storm preempting J1, J4 preempting J1,
                 the flood's duplicates rejected and /submit's 429, J3's
                 step graph captured beside another job's thread; a2. J5
                 killed by worker_death after round 1 and restarted, J6 (no
                 such model) failed after 2 attempts, J7 done; every job
                 bit-equal to its config's standalone run on the card (each
                 matrix cell to its run_fast), K1 and K3 launched as the
                 jobs' rounds need; b, beside a and a2: `python -m
                 attackfl_tpu_torch serve` as a process, three `job
                 submit`s, kill -9 mid-run, a torn queued entry, a
                 restart: every job done and bit-equal, then SIGTERM
                 exits 0; c. the fleet observatory on those spools: a's
                 /fleet (no error) and SLO gauges (a p95 queue wait per
                 priority class, the preemption rate above 0, the shed
                 rate the stream's) before its service closes, `watch
                 --fleet --once` against b's second daemon, then `fleet
                 report --json` (books closed, the slots, a row for every
                 dispatched job, J6 failed and the rest completed, J1
                 preempted, every row priced) and `fleet trace` on a's,
                 a2's and b's spools, `metrics --merge` (and
                 `--forensics`) on a's, and the bill of b's killed job
                 beside its slot events and its runs; no job, no kernel
                 launch.
 21. client mesh in one process -- config 4 (cut) over a 2-shard mesh
                 of cuda:0 (mesh_phase): a. K1 from a warm state at C=100,
                 two launches of 50 clients at bases 0 and 50 against one
                 of 100, bit for bit, the base's launch against its plain
                 version at phase 3's gates; b. pallas with threefry keys
                 (shard_map): round 1's local update bit for bit, the ok
                 sequence, the params after round 1 within 1e-5 of the
                 meshless run's, K1 2 x epochs a broadcast; c. one round
                 under xla with rbg keys (gspmd): the rows bit for bit or,
                 where cuBLAS parts them, within 2e-4 on the entries whose
                 first-step |g| is at least 1e-6, the aggregate of the
                 same rows within 1e-5, K3 2 x steps; d. each of the ten
                 defenses sharded on b's round-1 rows: the gather modes
                 bit for bit, the psum modes within 2e-6, the collectives
                 each records the table's; e. the one-device mesh `run`
                 builds, under each backend: the meshless run bit for bit
                 with its launches; f. a 2 x 2 x 1 sweep's cell axis over
                 the mesh: every cell bit for bit, no collective; g. the
                 sharded programs and the cell-sharded sweep under the
                 program audit: no sync, the table's collectives.
 22. client mesh over processes -- two ranks, each a fresh interpreter
                 (``chip_smoke.py --child``) holding one shard of cuda:0,
                 joined over 127.0.0.1 (multiprocess_phase): a. `python -m
                 attackfl_tpu_torch run --coordinator --num-processes 2
                 --process-id {0,1}` on config 4 (cut) under pallas, each
                 rank in its own directory: process 0's checkpoint against
                 the 2-shard single-process run of the same config file
                 bit for bit, rank 1 writing none, the ranks' AUCs alike,
                 K1 ranks x epochs x rounds; b. a round under xla (rbg,
                 gspmd): the gathered rows and params against 21c's
                 2-shard run bit for bit, K3 ranks x steps; and 3 rounds
                 under pallas with threefry (shard_map, the psum across
                 processes) against 21b's final state bit for bit; c. a
                 `load_parameters` restart of a: each rank restores process
                 0's broadcast bytes (their count the file's size), the
                 state the checkpoint's bit for bit; d. a's events.0.jsonl
                 and events.1.jsonl under one run_id, a run_header each
                 stamped with its process_index, `metrics --merge` exit 0
                 with a skew report.
 23. config 4 at full scale -- BASELINE config 4 uncut (100 clients, 25
                 LIE attackers, 5 epochs, 12,000-15,000 samples a
                 client, 30 rounds), the workload of the JAX package's
                 FULL_PARITY_JAX.json, under pallas: written as a config
                 file and run through `python -m attackfl_tpu_torch run
                 --config` in this process; every round ok, the final
                 ROC-AUC within 0.02 of the JAX package's 0.9228, rounds
                 16-30 printed beside full_parity_jax.log's, K1 150
                 launches; K1's first two launches (round 1's epochs 0
                 and 1, the cold and the warm Adam state, 118 steps
                 each) held against its plain version on their own
                 inputs, with the run's dropout and without, at phase
                 3's tolerances.  ``--only 23 --backend xla`` and
                 ``--seed N`` run the same workload under xla or at
                 another seed.
Phases 9 and 10 run their ICU models at 600-750 samples a client
(ICU_CUT), as do phases 11b, 12d, 13d, 15e and 16e hyper config 2, and
phases 14a and d, 15a-b, 16a-d and 18a-b config 4 (cut) at half phase
4's samples (SEQUEL_CUT), every shape kept, so that the script's time
stays as phases are added.  Phase 19b keeps phase
4's samples: its card-against-CPU gradient gate is set for them.
Each of phases 4-15 resets the kernel launch counts before each run and
requires the run's kernel to have been launched.  The kernels record's
launches are phase 4's main path's, phase 13a's pipelined runs', phase
14a's runs with telemetry on, phase 15a's runs with numerics on, phase
16a's windowed runs, phase 17a's sweep, phase 18's programs and runs,
phase 19b's gradient runs, 19c's run through adam_step and 19d's runs,
phase 20's service jobs (a's, a2's, and b's daemons' by their /metrics),
phase 21's mesh runs (b, c, e) and sharded sweep (f), phase 22's
ranks' runs (a, b), which each rank counts and reports on its CHILD line,
and phase 23's run.
The second-to-last line is the kernels JSON record, the last line
``{"ok": true, "device": {...}}``.  It needs one CUDA device and the CUDA
toolkit, imports nothing of JAX, and fails when run outside the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import unittest.mock
import urllib.error
import urllib.request
import warnings
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attackfl_tpu_torch import cli, validate_kernels  # noqa: E402
from attackfl_tpu_torch.config import (  # noqa: E402
    AttackSpec, Config, HyperDetectionConfig, MeshConfig, TelemetryConfig, load_config,
)
from attackfl_tpu_torch.analysis import program_audit, retrace  # noqa: E402
from attackfl_tpu_torch.costmodel import cli as costcli  # noqa: E402
from attackfl_tpu_torch.costmodel.peaks import H100  # noqa: E402
from attackfl_tpu_torch.faults.plan import parse_fault_plan  # noqa: E402
from attackfl_tpu_torch.matrix import program as matrix_program  # noqa: E402
from attackfl_tpu_torch.matrix.grid import GridSpec, cell_config  # noqa: E402
from attackfl_tpu_torch.data.partition import random_permutations  # noqa: E402
from attackfl_tpu_torch.data.synthetic import get_dataset  # noqa: E402
from attackfl_tpu_torch.device import resolve_device  # noqa: E402
from attackfl_tpu_torch.models.har import TransformerClassifier  # noqa: E402
from attackfl_tpu_torch.models.hyper import make_hypernetwork  # noqa: E402
from attackfl_tpu_torch.models.icu import T_HEAD, TransformerModel  # noqa: E402
from attackfl_tpu_torch.ops import aggregators, attacks, build, defenses  # noqa: E402
from attackfl_tpu_torch.ops import fused_step as tfs  # noqa: E402
from attackfl_tpu_torch.ops import metrics as tmetrics  # noqa: E402
from attackfl_tpu_torch.ledger import compare as ledger_compare  # noqa: E402
from attackfl_tpu_torch.ledger.store import LedgerStore  # noqa: E402
from attackfl_tpu_torch.ops.pytree import (  # noqa: E402
    tree_broadcast, tree_items, tree_leaves, tree_map, tree_ravel_stacked, tree_take, unraveler,
)
from attackfl_tpu_torch.profile_round import CONFIG4, DEPTH, self_device_us  # noqa: E402
from attackfl_tpu_torch.profiler import mine  # noqa: E402
from attackfl_tpu_torch.telemetry import merge  # noqa: E402
from attackfl_tpu_torch.telemetry.events import validate_event  # noqa: E402
from attackfl_tpu_torch.telemetry.summary import load_events  # noqa: E402
from attackfl_tpu_torch.training import local  # noqa: E402
from attackfl_tpu_torch.training import matrix_exec  # noqa: E402
from attackfl_tpu_torch.training.matrix_exec import MatrixRun  # noqa: E402
from attackfl_tpu_torch.training import engine  # noqa: E402
from attackfl_tpu_torch.training.hyper import build_hyper_update  # noqa: E402
from attackfl_tpu_torch.training import round as tround  # noqa: E402
from attackfl_tpu_torch.training.engine import Simulator  # noqa: E402
from attackfl_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint  # noqa: E402

# BASELINE config 4 is cut in depth only (width, clients, attackers and
# batch stay as published): epochs and samples per client to DEPTH["cut"],
# rounds from 30 to 3
ROUNDS = (30, 3)

# published peaks of the H100 SXM (NVIDIA's data sheet, the cost model's
# row in costmodel/peaks.py): fp32 outside the tensor cores, and HBM
# bandwidth.  INT32: an SM issues 64 INT32 lanes per clock against 128 FP32
# lanes (Hopper architecture white paper), half the fp32 rate
FP32_FLOPS, HBM_BYTES = H100["flops_per_sec"], H100["bytes_per_sec"]
INT32_OPS = FP32_FLOPS / 2
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
# the ICU runs of phases 9 and 10 (config 1, RNNModel, config 2, CNNHyper,
# config 4 hyper) at 600-750 samples a client, half the 1,200-1,500 they
# trained before phase 23 counted
ICU_CUT = dict(num_data_range=(600, 750), epochs=2, num_round=3)
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
# where the two float32 steps part at a ReLU's kink: the ReLU inputs whose
# sign on the card differs from float64's lie within this share of their
# tensor's largest |input| (float32 rounding of a normalised activation
# is ~1e-6 of it)
KINK_RTOL = 1e-4
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
# phase 12.  a: run_fast's chunk length on config 4 (cut); b: the chunk
# lengths whose host syncs are counted, and the syncs a chunk makes: its
# one read of the card (Simulator._read_chunk), whatever its length;
# e: config.yaml cut to these clients, samples and rounds
FUSED_CHUNK, SYNC_CHUNKS, SYNCS_PER_CHUNK = 3, (1, 3), 1
SURFACE_CUT = {"clients": 3, "num-data-range": [256, 512], "num-round": 2}
# phase 13.  a: the pipeline's depths on config 4 (cut), and those whose
# run is profiled under pallas for the device's idle share; b: a plan that
# fails every client on broadcasts 2-4, run at DEMOTE_DEPTH with demotion
# after 2 rollbacks and re-promotion after 2 clean rounds; e: the stop
# hook says "drain" once this many rounds are done
PIPE_DEPTHS, PROFILED_DEPTHS = (0, 1, 2, 4), (0, 2)
DEMOTE_PLAN, DEMOTE_DEPTH = "nan_storm@2;nan_storm@3;nan_storm@4", 3
STOP_ROUNDS = 1
# phase 14.  a: each executor of config 4 (cut) with telemetry on, the
# pipeline at this depth; c: the modes whose rounds write an attribution
# event (the defense's verdict), each run for ATTRIBUTION_ROUNDS rounds,
# the last attacking
TELEMETRY_EXECUTORS, TELEMETRY_DEPTH = ("run", "run_fast", "pipeline"), 2
# phases 14a and d, 15a-b, 16a-d and 18a-b run config 4 (cut) at
# these samples a client, half phase 4's (6 steps an epoch in place of 12;
# every shape kept, and each gate holds within those runs), which saves the
# time phase 22 adds
SEQUEL_CUT = dict(num_data_range=(600, 750))
# a's longer run under pallas, which spreads the run's end over more rounds
TELEMETRY_LONG_ROUNDS = 20
ATTRIBUTION_MODES = ("median", "trimmed_mean", "krum", "shieldfl", "byzantine", "scionfl",
                     "FLTrust", "gmm", "fltracer")
ATTRIBUTION_ROUNDS = 2
# phase 15.  a: config 4 (cut) through each of TELEMETRY_EXECUTORS with the
# numerics ring of this window (run's 3 rounds drain at round 2 and at the
# end); b: the card's row against the CPU's within this relative tolerance
# (and the histogram's edges within it); c: phase 11a's plan with the
# monitor stalled at STALL_ROUND, over STALL_RUN_ROUNDS rounds
NUMERICS_WINDOW, NUMERICS_RTOL = 2, 1e-5
STALL_ROUND, STALL_RUN_ROUNDS = 3, 4
# phase 16.  a: config 4 (cut) through each of TELEMETRY_EXECUTORS under
# each backend with this hotspot window and the cost model on, then with
# neither; each executor's dispatch seam and record_function label; the
# port's kernels' trace rows by name, with the categories the tests fix;
# the label's cost timed over LABEL_REPS labels.  b: the ledger's
# utilization within (0, UTILIZATION_CAP]
HOTSPOT_WINDOW = "2:3"
HOTSPOT_SEAM = {"run": "sync", "run_fast": "fused", "pipeline": "pipelined"}
HOTSPOT_LABELS = {"run": ("round_step", "aggregate"), "run_fast": (f"fused_scan[{ROUNDS[1]}]",),
                  "pipeline": ("pipeline_step[eval=True]",)}
KERNEL_ROWS = {"fused_step": ("train_epoch_kernel", "matmul"),
               "dropout_mask": ("fill_masks", "copy")}
LABEL_REPS = 20000
UTILIZATION_CAP = 1.05
# e: hyper config 2's window, its last round (the RNN's small ops make a
# round's trace several times config 4's)
HYPER_WINDOW = "3:3"
# filled by main_path (each backend's run history) and checkpoint_phase
# (the gap between two config-4 runs without a stop, per backend), and by
# fault_run (the faulted run's final state, per backend)
MAIN_HISTORY: dict = {}
MAIN_STATES: dict = {}
RUN_GAPS: dict = {}
# K1 against its plain version in later phases: 21a's with a client base,
# 23's on its own first launches' inputs
PHASE_ERRORS: dict = {}
# phase 21b's and 21c's 2-shard single-process states (on the host), the
# references of phase 22's two-process runs
MESH_REFS: dict = {}
FAULT_STATES: dict = {}


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
    # the seed in device memory, as the round's draw hands it to K1
    seed = torch.full((), 1, dtype=torch.int64, device="cuda")
    ms = time_ms(lambda: tfs.run_epoch(tp, tm, tv, batches, seed, 0, **kw))
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
        per_step.append(time_ms(lambda: tfs.run_epoch(tp, tm, tv, rb, seed, 0, **kw),
                                reps=15) / nb)
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


def k3_bound_ms(C: int, specs) -> tuple[float, float]:
    """K3's bound in ms, (bytes, operations), from ``mask_work``: the
    masks' floats written and C int64 keys read at HBM_BYTES;
    tfs.K3_OPS_PER_ELEMENT int32 operations per element at INT32_OPS."""
    work = tfs.mask_work(C, specs)
    return work["bytes"] / HBM_BYTES * 1e3, work["flops"] / INT32_OPS * 1e3


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
    t_bytes, t_ops = k3_bound_ms(C, step)
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
        f"written at 3.35 TB/s; {tfs.K3_OPS_PER_ELEMENT * n_step / 1e6:.1f} M int32 ops take "
        f"{t_ops * 1e3:.3f} us); {bound / ms:.1%} of the bound")

    one_ms = device_ms(lambda: tfs.fill_mask(keys, T_HEAD, B, big[2], 0.1))
    one_plain = device_ms(lambda: tfs.dropout_mask(keys, T_HEAD, B, big[2], 0.1), reps=20)
    one_bytes, one_ops = k3_bound_ms(C, [(T_HEAD, B, big[2], 0.1)])
    log(f"[kernels] K3 {list(big)}: kernel {one_ms * 1e3:.3f} us/launch, plain "
        f"{one_plain * 1e3:.3f} us, bound {max(one_bytes, one_ops) * 1e3:.3f} us "
        f"({4 * math.prod(big) / 1e6:.2f} MB written at 3.35 TB/s; "
        f"{tfs.K3_OPS_PER_ELEMENT * math.prod(big) / 1e6:.1f} M int32 ops take "
        f"{one_ops * 1e3:.3f} us)")

    har_keys = tfs.client_keys(2024, 5, torch.arange(har_C, device="cuda"))
    n_har = har_C * sum(r * w for _, r, w, _ in har)
    har_bytes, har_ops = k3_bound_ms(har_C, har)
    har_ms = device_ms(lambda: tfs.fill_masks(har_keys, har), reps=20)
    har_plain = device_ms(lambda: tfs.dropout_masks(har_keys, har), reps=2)
    log(f"[kernels] K3 HAR step set C={har_C} B={har_B} L={HAR_L}: kernel "
        f"{har_ms * 1e3:.3f} us/launch, plain {har_plain * 1e3:.3f} us; bound "
        f"{max(har_bytes, har_ops) * 1e3:.3f} us ({4 * n_har / 1e6:.1f} MB written at 3.35 "
        f"TB/s; {tfs.K3_OPS_PER_ELEMENT * n_har / 1e6:.1f} M int32 ops take {har_ops * 1e3:.3f} "
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
    # the root set trains for each aggregate and, with telemetry on, once
    # more for the round's attribution event (JAX round.py:621-633)
    root_trainings = aggregated * (2 if sim._attribution is not None else 1)
    root_steps = root_trainings * cfg.epochs * -(-tround.ROOT_SIZE // tround.ROOT_BATCH)
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
        extra = (f"; K3 launches of the root training {root_steps} (2 steps an epoch, "
                 f"{root_trainings} trainings: the aggregates' and the attribution's)")
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


def step_args(sim: Simulator, params: dict, C: int, B: int, dev: str,
              dtype: torch.dtype = torch.float32) -> tuple[dict, tuple]:
    """The inputs of one minibatch step of C clients on ``dev`` in
    ``dtype``: (the params' tree as a template, the step's arguments:
    ``params`` nudged per client by a seeded 1e-3 [C, P], a seeded batch,
    its labels, a mask of ones and K3's masks of a fixed key).  The same
    values on every device."""
    model, data_name = sim.model, sim.cfg.data_name
    names = local.INPUTS[data_name]
    gen = torch.Generator().manual_seed(13)
    n = sim.train_data["label"].shape[0]
    idx = torch.randint(0, n, (C, B), generator=gen)
    template = tree_map(lambda x: x.cpu().to(dtype), params)
    flat = tree_ravel_stacked(tree_broadcast(tree_map(lambda x: x.cpu(), params), C))
    flat = (flat + 1e-3 * torch.randn(flat.shape, generator=gen)).to(dtype)
    keys = tfs.client_keys(17, 3, torch.arange(C))
    specs = model.mask_specs([(B,) + tuple(sim.train_data[k].shape[1:]) for k in names],
                             model.dropout_rates)
    data = {k: v.to(dev) for k, v in sim.train_data.items()}
    labels = local.labels_of(data, data_name)
    rows = idx.to(dev)
    masks = local.step_masks(keys.to(dev), specs)
    inputs = tuple(data[k][rows].to(dtype) if data[k].is_floating_point() else data[k][rows]
                   for k in names)
    return template, (flat.to(dev), inputs, labels[rows],
                      torch.ones((C, B), device=dev, dtype=dtype), masks)


def one_step(sim: Simulator, params: dict, C: int, B: int, dev: str,
             dtype: torch.dtype = torch.float32):
    """One minibatch step (``step_args``) through the port's
    ``local.build_step_grad``: (grads [C, P], losses [C], masks), on the
    CPU in float64."""
    template, args = step_args(sim, params, C, B, dev, dtype)
    step = local.build_step_grad(sim.model, sim.cfg.data_name, template)
    grads, loss = step(*args[:4], *(() if args[4] is None else (args[4],)))
    return (grads.cpu().to(torch.float64), loss.cpu().to(torch.float64),
            None if args[4] is None else [m.cpu() for m in args[4]])


def relu_inputs(sim: Simulator, template: dict, args: tuple) -> tuple[list, torch.Tensor]:
    """The step's forward (``step_args``), vmapped over clients as the
    step's is: (the input of every ``F.relu`` call [C, ...], in call
    order, on the CPU; the losses [C])."""
    loss_fn, unravel = local.make_loss_fn(sim.model, sim.cfg.data_name), unraveler(template)
    relu = F.relu

    def forward(row, inputs, label, mask, *masks):
        seen = []

        def tap(x, inplace=False):
            seen.append(x)
            return relu(x)

        with unittest.mock.patch.object(F, "relu", tap):
            loss = loss_fn(unravel(row), inputs, label, mask, *masks)
        return tuple(seen), loss

    with torch.no_grad():
        acts, loss = torch.func.vmap(forward)(*args[:4], *args[4:] if args[4] is not None else ())
    return [a.cpu() for a in acts], loss.cpu()


def step_on_pattern(sim: Simulator, template: dict, args: tuple, pattern: list) -> torch.Tensor:
    """The step's per-client gradients [C, P] (``step_args``) with every
    ``F.relu`` call's derivative fixed: the i-th call is ``x *
    pattern[i]``, a 0/1 tensor [C, ...]: the same piece of the
    piecewise-linear network in any precision."""
    loss_fn, unravel = local.make_loss_fn(sim.model, sim.cfg.data_name), unraveler(template)

    def loss_of_row(row, inputs, label, mask, pats, *masks):
        it = iter(pats)
        with unittest.mock.patch.object(F, "relu", lambda x, inplace=False: x * next(it)):
            return loss_fn(unravel(row), inputs, label, mask, *masks)

    grads, _ = torch.func.vmap(torch.func.grad_and_value(loss_of_row))(
        *args[:4], tuple(pattern), *args[4:] if args[4] is not None else ())
    return grads.cpu().to(torch.float64)


def step_on_card_and_cpu(label: str, sim: Simulator, params: dict, C: int, B: int) -> None:
    """One minibatch step of C clients from the same params (``params``,
    nudged per client by a seeded 1e-3), batch and K3 masks on the card
    and on the CPU: the masks equal, losses within STEP_LOSS_TOL of
    max(1, |loss|), and per-client gradients within STEP_GRAD_RTOL of the
    largest |g|, either of the CPU's step or, where the two float32 steps
    fall on either side of a ReLU's kink, of the same piece of the
    network in float64 (``kink_gate``).  A failing state's params are
    saved to the temporary directory."""
    g_card, l_card, m_card = one_step(sim, params, C, B, "cuda")
    g_cpu, l_cpu, m_cpu = one_step(sim, params, C, B, "cpu")
    same_masks = m_card is None or all(torch.equal(a, b) for a, b in zip(m_card, m_cpu))
    scale = float(g_cpu.abs().max())
    g_err, l_err = float((g_card - g_cpu).abs().max()), float((l_card - l_cpu).abs().max())
    l_tol = STEP_LOSS_TOL * max(1.0, float(l_cpu.abs().max()))
    n_masks = 0 if m_card is None else len(m_card)
    log(f"[models] {label}: one step C={C} B={B} card vs CPU: K3 masks equal to the CPU's "
        f"{same_masks} ({n_masks} tensors), max |d grad| {g_err:.3e} = {g_err / scale:.3e} of "
        f"max |g| {scale:.3e} (tol {STEP_GRAD_RTOL}), max |d loss| {l_err:.3e} of losses up to "
        f"{float(l_cpu.abs().max()):.4f} (tol {l_tol:.3e})")
    ok = same_masks and l_err <= l_tol
    if ok and g_err > STEP_GRAD_RTOL * scale:
        ok = kink_gate(label, sim, params, C, B, g_card, l_card)
    if not ok:
        path = os.path.join(tempfile.gettempdir(), f"chip_smoke_{label.replace(' ', '_')}.pt")
        torch.save(tree_map(lambda x: x.cpu(), params), path)
        raise AssertionError(f"{label}: the card's step differs from the CPU's (params in "
                             f"{path})")


def kink_gate(label: str, sim: Simulator, params: dict, C: int, B: int, g_card: torch.Tensor,
              l_card: torch.Tensor) -> bool:
    """Where the card's float32 step and the CPU's part by more than
    STEP_GRAD_RTOL: a ReLU network's gradient jumps where a ReLU's input
    crosses zero, and a float32 forward's rounding decides the side of an
    input within its rounding error of zero.  True if every ReLU input
    whose sign on the card differs from float64's on the CPU lies within
    KINK_RTOL of its tensor's largest |input|, and the card's step is
    within STEP_GRAD_RTOL of the same piece of the network (the card's
    ReLU pattern) in float64 on the CPU.  Prints the CPU's float32 step on
    that piece against float64 too, the jump between the two pieces in
    float64, and the card's float64 step against the CPU's."""
    template, card_args = step_args(sim, params, C, B, "cuda")
    card_acts, card_loss = relu_inputs(sim, template, card_args)
    template64, cpu64_args = step_args(sim, params, C, B, "cpu", torch.float64)
    cpu64_acts, _ = relu_inputs(sim, template64, cpu64_args)
    flips, worst = 0, 0.0
    for a, b in zip(card_acts, cpu64_acts):
        differ = (a > 0) != (b > 0)
        flips += int(differ.sum())
        if differ.any():
            worst = max(worst, float(b[differ].abs().max() / b.abs().max()))
    pattern = [(a > 0).to(torch.float64) for a in card_acts]
    g64 = step_on_pattern(sim, template64, cpu64_args, pattern)
    template32, cpu32_args = step_args(sim, params, C, B, "cpu")
    g32 = step_on_pattern(sim, template32, cpu32_args, [p.float() for p in pattern])
    g64_own, _, _ = one_step(sim, params, C, B, "cpu", torch.float64)
    g64_card, _, _ = one_step(sim, params, C, B, "cuda", torch.float64)
    scale = float(g64.abs().max())
    card_err = float((g_card - g64).abs().max()) / scale
    ok = worst <= KINK_RTOL and card_err <= STEP_GRAD_RTOL
    log(f"[models] {label}: the float32 steps part at a ReLU kink: {flips} of "
        f"{sum(a.numel() for a in card_acts)} ReLU inputs on the other side of zero on the card "
        f"than in float64, the farthest {worst:.3e} of its tensor's largest |input| (tol "
        f"{KINK_RTOL}); the step's forward equal to the gradient step's "
        f"{torch.equal(card_loss, l_card.float())}; on the card's piece, shares of max |g| "
        f"{scale:.4e} from float64 on the CPU: card {card_err:.3e} (tol {STEP_GRAD_RTOL}), CPU "
        f"float32 {float((g32 - g64).abs().max()) / scale:.3e}; float64 across the kink "
        f"{float((g64_own - g64).abs().max()) / scale:.3e}; the card's float64 step from the "
        f"CPU's {float((g64_card - g64_own).abs().max()) / scale:.3e}; ok={ok}")
    return ok


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
    CPU from the run's last params (config 5's also from its initial
    params), config 1's round at full depth, and config 5's vmap-vs-loop
    step; each part's seconds.

    Config 5's float32 steps at its initial state fall on either side of
    a ReLU's kink on the card and on the CPU (the card's step is ~1.6e-3
    of the largest |g| from the CPU's), as some of its later states do:
    the gate there holds the card to float64 on the card's side of the
    kink (``kink_gate``), and this state takes that branch in every
    call."""
    for label, config, cut in MODEL_RUNS:
        t0 = time.perf_counter()
        sim, state = model_run(label, config, cut, card)
        t1 = time.perf_counter()
        C, B = STEP_SHAPE.get(label, (config["total_clients"], config["batch_size"]))
        step_on_card_and_cpu(label, sim, state["global_params"], C, B)
        if config["model"] == "ResNet18":
            step_on_card_and_cpu(f"{label} initial state", sim,
                                 sim.init_state()["global_params"], C, B)
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
    FAULT_STATES[backend] = whole
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


@contextlib.contextmanager
def sync_log():
    """A block under ``torch.cuda.set_sync_debug_mode("warn")``: yields
    the list its warnings land in (``syncs_of`` picks the syncs)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def syncs_of(caught: list) -> list:
    return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, the synchronizing CUDA operations it made (each copy between
    the host and the card from pageable memory, each stream sync, each
    read of a device value), and where in the Python code they were."""
    with sync_log() as caught:
        out = fn()
    syncs = syncs_of(caught)
    sites = Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in syncs)
    return out, len(syncs), sites


def fused_runs() -> None:
    """Phase 12 a and b: config 4 (cut) through run_fast under each
    backend, then the host syncs of run and of run_fast chunks."""
    for backend in ("pallas", "xla"):
        cfg = cut_config(local_backend=backend)
        sim = Simulator(cfg, device="cuda")
        state = sim.init_state()
        reset_launches()
        state, history = sim.run_fast(state=state, chunk_size=FUSED_CHUNK,
                                      save_checkpoints=False, verbose=False)
        launches = launch_counts()
        gap = max_param_gap(state["global_params"], MAIN_STATES[backend]["global_params"])
        got = [(round(h["roc_auc"], 4), round(h["train_loss"], 4)) for h in history]
        per_round = [h["chunk_seconds"] / h["chunk_len"] for h in history[::FUSED_CHUNK]]
        log(f"[fused] {backend}: run_fast(chunk_size={FUSED_CHUNK}) {len(history)} rounds "
            f"ok={[h['ok'] for h in history]}; (AUC, loss) {got}; chunk lengths "
            f"{[h['chunk_len'] for h in history]}; max |d params| from phase 4's run {gap:.3e} "
            f"(two runs without a stop: {RUN_GAPS[backend]:.3e}); launches {launches}; "
            f"s/round {[round(t, 4) for t in per_round]} (chunk seconds / chunk length) "
            f"against run's {[round(h['seconds'], 4) for h in MAIN_HISTORY[backend]]} in "
            f"phase 4 ({card_line()})")
        if not all(h["ok"] for h in history) or got != BASELINE_ROUNDS[backend]:
            raise AssertionError(f"fused {backend}: rounds {got} differ from "
                                 f"{BASELINE_ROUNDS[backend]}")
        if gap > RUN_GAPS[backend]:
            raise AssertionError(f"fused {backend}: the params left phase 4's run's")
        require_kernel(f"fused {backend}", cfg, launches, len(history))

    for backend in ("pallas", "xla"):
        sim = Simulator(cut_config(local_backend=backend), device="cuda")
        state = sim.init_state()
        _, per_round, sites = count_syncs(lambda: sim.run_round(state))
        chunks = {}
        for n in SYNC_CHUNKS:
            fresh = sim.init_state()
            (_, history), chunks[n], chunk_sites = count_syncs(lambda: sim.run_fast(
                num_rounds=n, state=fresh, chunk_size=n, save_checkpoints=False,
                verbose=False))
            if len(history) != n or not all(h["ok"] for h in history):
                raise AssertionError(f"syncs {backend}: the chunk of {n} was not one ok chunk")
            log(f"[fused] {backend}: a run_fast chunk of {n} made {chunks[n]} host syncs, at "
                f"{dict(chunk_sites)}")
        log(f"[fused] {backend}: host syncs of one run round {per_round} (at {dict(sites)}); "
            f"of a run_fast chunk {chunks} by chunk length (documented: {SYNCS_PER_CHUNK})")
        if set(chunks.values()) != {SYNCS_PER_CHUNK}:
            raise AssertionError(f"syncs {backend}: a chunk made {chunks} syncs, not "
                                 f"{SYNCS_PER_CHUNK} at every length")


def fused_fault_run(backend: str, root: str) -> None:
    """Phase 12 c: FAULT_PLAN under run_fast(chunk_size=1) with
    checkpoints, then 2 rounds into another directory and a resumed
    Simulator's run_fast for round 3."""
    plan = parse_fault_plan(FAULT_PLAN)
    whole_dir = os.path.join(root, "fused", backend, "whole")
    cut_dir = os.path.join(root, "fused", backend, "cut")
    sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=whole_dir, faults=plan),
                    device="cuda")
    state = sim.init_state()
    reset_launches()
    whole, history = sim.run_fast(state=state, chunk_size=1, verbose=False)
    launches = launch_counts()
    seq = [(h["broadcast"], h["ok"]) for h in history]
    gap = max_param_gap(whole["global_params"], FAULT_STATES[backend]["global_params"])
    rounds = [e["round"] for e in sim.checkpoints.read_manifest()["entries"]]
    log(f"[fused] {backend} faults: broadcasts (number, ok) {seq}; max |d params| from phase "
        f"11a's run {gap:.3e}; injected {[(r['fault'], r['round']) for r in sim.fault_injector.records]}; "
        f"manifest rounds {rounds}; launches {launches}")
    if seq != [(1, True), (2, False), (3, True), (4, True)] or gap > RUN_GAPS[backend]:
        raise AssertionError(f"fused {backend} faults: broadcasts {seq}, gap {gap:.3e}")
    require_kernel(f"fused {backend} faults", sim.cfg, launches, len(history))

    Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir, faults=plan),
              device="cuda").run_fast(num_rounds=2, chunk_size=1, verbose=False)
    resumed_sim = Simulator(cut_config(local_backend=backend, checkpoint_dir=cut_dir,
                                       faults=plan, resume=True), device="cuda")
    state = resumed_sim.load_or_init_state()
    reset_launches()
    resumed, rest = resumed_sim.run_fast(state=state, chunk_size=1, verbose=False)
    launches = launch_counts()
    gap = max_param_gap(resumed["global_params"], whole["global_params"])
    log(f"[fused] {backend} faults: resume from round {state['completed_rounds']} (the round-2 "
        f"entry torn); resumed (round, broadcast, ok) "
        f"{[(h['round'], h['broadcast'], h['ok']) for h in rest]}; resumed vs uninterrupted "
        f"max |d params| {gap:.3e}; launches {launches}")
    if state["completed_rounds"] != 1 or [h["round"] for h in rest] != [2, 3]:
        raise AssertionError(f"fused {backend}: the resume did not fall back past the torn entry")
    if gap > RUN_GAPS[backend]:
        raise AssertionError(f"fused {backend}: the resumed run left the uninterrupted one")
    require_kernel(f"fused {backend} resumed", resumed_sim.cfg, launches, len(rest))


def fused_hyper_run(workdir: str) -> None:
    """Phase 12 d: hyper config 2 (cut) under run and under run_fast."""
    label, config, cut = HYPER_RUNS[0]
    cfg = Config(**{**config, **cut, "log_path": workdir, "checkpoint_dir": workdir})
    states = {}
    for how in ("run", "run_fast"):
        sim = Simulator(cfg, device="cuda")
        state = sim.init_state()
        reset_launches()
        t0 = time.perf_counter()
        states[how], history = getattr(sim, how)(state=state, save_checkpoints=False,
                                                 verbose=False)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        log(f"[fused] hyper {label} {how}: {len(history)} rounds ok="
            f"{[h['ok'] for h in history]} in {seconds:.3f} s; AUC "
            f"{[round(h['roc_auc'], 4) for h in history]}; launches {launches}")
        require_kernel(f"hyper {how}", cfg, launches, len(history))
    a, b = states["run"], states["run_fast"]
    same = (torch.equal(a["hnet_params"], b["hnet_params"])
            and all(torch.equal(a["hyper_opt_state"][k], b["hyper_opt_state"][k])
                    for k in ("count", "m", "v")))
    log(f"[fused] hyper {label}: run_fast's hypernetwork and Adam state equal run's bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("hyper: run_fast's hypernetwork differs from run's")


def surface_yaml(workdir: str) -> str:
    """The repo's config.yaml cut to SURFACE_CUT, logging into
    ``workdir``, written there; its path."""
    import yaml

    with open(os.path.join(REPO, "config.yaml")) as fh:
        doc = yaml.safe_load(fh)
    server = doc["server"]
    server["clients"], server["num-round"] = SURFACE_CUT["clients"], SURFACE_CUT["num-round"]
    server.setdefault("data-distribution", {})["num-data-range"] = SURFACE_CUT["num-data-range"]
    doc["log_path"] = workdir
    path = os.path.join(workdir, "config.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh)
    return path


def launch_surface(workdir: str) -> None:
    """Phase 12 e: three client registrations through `python -m
    attackfl_tpu_torch client`, then the server through the same CLI,
    in this process so that its kernel launches are counted."""
    path = surface_yaml(workdir)
    for args in ([], ["--attack", "True", "--attack_mode", "LIE", "--attack_round", "1"], []):
        subprocess.run([sys.executable, "-m", "attackfl_tpu_torch", "client", "--config", path,
                        *args], cwd=REPO, check=True, capture_output=True, text=True,
                       timeout=120)
    reg_dir = os.path.join(workdir, cli.REG_DIR)
    regs = []
    for name in sorted(os.listdir(reg_dir)):
        with open(os.path.join(reg_dir, name)) as fh:
            regs.append(json.load(fh))
    expect = tuple(AttackSpec(mode="LIE", client_ids=(i,), attack_round=1)
                   for i, reg in enumerate(regs) if reg["attack"])
    built = []

    class Recording(Simulator):
        def __init__(self, cfg, *args, **kwargs):
            built.append(cfg)
            super().__init__(cfg, *args, **kwargs)

    reset_launches()
    engine.Simulator = Recording
    t0 = time.perf_counter()
    try:
        rc = cli.main(["server", "--config", path, "--rounds", "1"])
        torch.cuda.synchronize()
    finally:
        engine.Simulator = Simulator
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(workdir, "app.log")) as fh:
        lines = [line.split(" - ", 1)[1] for line in fh.read().splitlines()]
    attacks = built[0].attacks if built else None
    log(f"[surface] 3 clients registered ({[r['attack'] for r in regs]}), server --rounds 1: "
        f"exit {rc} in {seconds:.3f} s (construction included); attackers {attacks}; app.log "
        f"{lines}; launches {launches}; left in {cli.REG_DIR}: {os.listdir(reg_dir)}")
    if rc != 0 or attacks != expect or len(expect) != 1:
        raise AssertionError(f"surface: exit {rc}, attackers {attacks}, expected {expect}")
    if lines[0] != "INFO - ### Application start ###" or not any(
            "roc_auc=" in line for line in lines[1:]):
        raise AssertionError(f"surface: app.log holds {lines}")
    require_kernel("surface", built[0], launches, 1)


def fused_phase() -> None:
    """Phase 12: runs a-e."""
    root = tempfile.mkdtemp(prefix="chip_smoke_fused_")
    try:
        t0 = time.perf_counter()
        fused_runs()
        t1 = time.perf_counter()
        for backend in ("pallas", "xla"):
            fused_fault_run(backend, root)
        t2 = time.perf_counter()
        fused_hyper_run(root)
        t3 = time.perf_counter()
        surface = os.path.join(root, "surface")
        os.makedirs(surface)
        launch_surface(surface)
        log(f"[phase 12] a+b {t1 - t0:.1f} s, c {t2 - t1:.1f} s, d {t3 - t2:.1f} s, e "
            f"{time.perf_counter() - t3:.1f} s")
    finally:
        shutil.rmtree(root)


def timed_pipeline(sim: Simulator) -> dict:
    """Time the Simulator's pipeline dispatch and resolve by the host
    clock: the milliseconds of each call, by name."""
    times: dict = {"dispatch": [], "resolve": []}
    for key in times:
        name = f"_{key}_pipeline_round"
        fn = getattr(sim, name)

        def timed(*args, fn=fn, key=key):
            t0 = time.perf_counter()
            out = fn(*args)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(sim, name, timed)
    return times


def pipeline_depth_runs() -> dict:
    """Phase 13 a: config 4 (cut) through run(pipeline=True) at each of
    PIPE_DEPTHS under each backend, then the host syncs of a depth-2
    run, then the device idle share of the PROFILED_DEPTHS under pallas.
    Returns the kernels' launches over the depth runs."""
    total = Counter()
    card = card_line()
    for backend in ("pallas", "xla"):
        for depth in PIPE_DEPTHS:
            cfg = cut_config(pipeline=True, local_backend=backend, pipeline_depth=depth)
            sim = Simulator(cfg, device="cuda")
            times = timed_pipeline(sim)
            state = sim.init_state()
            reset_launches()
            t0 = time.perf_counter()
            state, history = sim.run(state=state, save_checkpoints=False, verbose=False)
            wall = time.perf_counter() - t0
            launches = launch_counts()
            total.update(launches)
            label = f"pipeline {backend} depth {depth}"
            gap = max_param_gap(state["global_params"], MAIN_STATES[backend]["global_params"])
            seq = [(h["broadcast"], h["ok"]) for h in history]
            got = [(round(h["roc_auc"], 4), round(h["train_loss"], 4)) for h in history]
            n = len(history)
            log(f"[pipeline] {backend} depth {depth}: {n} rounds ok="
                f"{[h['ok'] for h in history]}; max |d params| from phase 4's run {gap:.3e} "
                f"(two runs without a stop: {RUN_GAPS[backend]:.3e}); s/round {wall / n:.4f} "
                f"(wall {wall:.4f} s; between resolves "
                f"{[round(h['seconds'], 4) for h in history]}); dispatch ms "
                f"{[round(t, 3) for t in times['dispatch']]}; resolve ms "
                f"{[round(t, 3) for t in times['resolve']]}; launches {launches} ({card})")
            if seq != [(h["broadcast"], h["ok"]) for h in MAIN_HISTORY[backend]]:
                raise AssertionError(f"{label}: broadcasts {seq} differ from phase 4's run")
            if got != BASELINE_ROUNDS[backend] or gap > RUN_GAPS[backend]:
                raise AssertionError(f"{label}: rounds {got}, gap {gap:.3e} from phase 4's run")
            require_kernel(label, cfg, launches, n)
        sim = Simulator(cut_config(pipeline=True, local_backend=backend, pipeline_depth=2),
                        device="cuda")
        state = sim.init_state()
        (_, history), syncs, sites = count_syncs(lambda: sim.run(
            state=state, save_checkpoints=False, verbose=False))
        log(f"[pipeline] {backend} depth 2: {syncs} host syncs over {len(history)} rounds "
            f"besides the resolves' event waits, at {dict(sites)}")
        if syncs:
            raise AssertionError(f"pipeline {backend}: {syncs} host syncs at {dict(sites)}")
    for depth in PROFILED_DEPTHS:
        sim = Simulator(cut_config(pipeline=True, local_backend="pallas",
                                   pipeline_depth=depth), device="cuda")
        state = sim.init_state()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, history = sim.run(state=state, save_checkpoints=False, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
        if not device:
            raise AssertionError("torch.profiler recorded no device activity in the pipeline")
        busy = busy_us(device) / 1e6
        n = len(history)
        log(f"[pipeline] pallas depth {depth} under torch.profiler: wall {wall / n:.4f} s/round, "
            f"device busy {busy / n:.4f} s/round, idle share {1 - busy / wall:.3f} ({card})")
    return dict(total)


def pipeline_fault_runs(root: str) -> None:
    """Phase 13 b: FAULT_PLAN at depth 2 under each backend, with
    checkpoints; then DEMOTE_PLAN at DEMOTE_DEPTH under pallas against
    run under the same plan."""
    plan = parse_fault_plan(FAULT_PLAN)
    for backend in ("pallas", "xla"):
        cfg = cut_config(pipeline=True, local_backend=backend, pipeline_depth=2, faults=plan,
                          checkpoint_dir=os.path.join(root, "plan", backend))
        sim = Simulator(cfg, device="cuda")
        state = sim.init_state()
        reset_launches()
        state, history = sim.run(state=state, verbose=False)
        launches = launch_counts()
        seq = [(h["broadcast"], h["ok"]) for h in history]
        gap = max_param_gap(state["global_params"], FAULT_STATES[backend]["global_params"])
        rounds = [e["round"] for e in sim.checkpoints.read_manifest()["entries"]]
        log(f"[pipeline] {backend} faults at depth 2: broadcasts (number, ok) {seq}; max |d "
            f"params| from phase 11a's run {gap:.3e}; injected "
            f"{[(r['fault'], r['round']) for r in sim.fault_injector.records]}; manifest "
            f"rounds {rounds}; launches {launches}")
        if seq != [(1, True), (2, False), (3, True), (4, True)] or gap > RUN_GAPS[backend]:
            raise AssertionError(f"pipeline {backend} faults: broadcasts {seq}, gap {gap:.3e}")
        if rounds != [1, 2, 3]:
            raise AssertionError(f"pipeline {backend} faults: manifest rounds {rounds}")
        require_kernel(f"pipeline {backend} faults", cfg, launches, len(history))

    cfg = cut_config(local_backend="pallas", faults=parse_fault_plan(DEMOTE_PLAN),
                     pipeline_depth=DEMOTE_DEPTH, pipeline_demote_after=2,
                     pipeline_repromote_after=2)
    run_sim = Simulator(cfg, device="cuda")
    run_state, run_hist = run_sim.run(state=run_sim.init_state(), save_checkpoints=False,
                                      verbose=False)
    sim = Simulator(cfg.replace(pipeline=True), device="cuda")
    state = sim.init_state()
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        state, history = sim.run(state=state, save_checkpoints=False, verbose=False)
    launches = launch_counts()
    printed = out.getvalue()
    demoted = printed.count(f"demoting from depth-{DEMOTE_DEPTH} to synchronous")
    repromoted = printed.count(f"re-promoted to depth-{DEMOTE_DEPTH} after")
    seq = [(h["broadcast"], h["ok"], h.get("degraded", False)) for h in history]
    gap = max_param_gap(state["global_params"], run_state["global_params"])
    log(f"[pipeline] pallas {DEMOTE_PLAN} at depth {DEMOTE_DEPTH}: (broadcast, ok, degraded) "
        f"{seq}; run's {[(h['broadcast'], h['ok']) for h in run_hist]}; max |d params| from "
        f"run {gap:.3e}; demotions {demoted}, re-promotions {repromoted}; launches {launches}")
    if [s[:2] for s in seq] != [(h["broadcast"], h["ok"]) for h in run_hist]:
        raise AssertionError("pipeline demotion: the ok sequence differs from run's")
    if gap > RUN_GAPS["pallas"] or demoted != 1 or repromoted != 1:
        raise AssertionError(f"pipeline demotion: gap {gap:.3e}, demotions {demoted}, "
                             f"re-promotions {repromoted}")
    require_kernel("pipeline demotion", cfg, launches, len(history))


def host_state_gap(a: dict, b: dict) -> float:
    """The largest |difference| of two host states' tensors; inf when a
    non-tensor value differs."""
    gap = 0.0
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            gap = max(gap, max_param_gap(x, y))
        elif isinstance(x, torch.Tensor):
            gap = max(gap, float((x.double() - y.double()).abs().max()))
        elif x != y:
            return math.inf
    return gap


def entry_states(sim: Simulator) -> dict:
    """Each manifest entry's host state, by its round."""
    template = sim.host_state(sim.init_state())
    return {e["round"]: ckpt.load_state(os.path.join(sim.checkpoints.directory, e["file"]),
                                        template)
            for e in sim.checkpoints.read_manifest()["entries"]}


def pipeline_checkpoint_runs(root: str) -> None:
    """Phase 13 c: run saving every round, then the pipeline at depth 2
    with the synchronous and with the async writer; then 2 rounds and a
    resumed pipeline for round 3."""
    run_sim = Simulator(cut_config(local_backend="pallas",
                                   checkpoint_dir=os.path.join(root, "ckpt", "run")),
                        device="cuda")
    run_sim.run(state=run_sim.init_state(), verbose=False)
    theirs = entry_states(run_sim)
    wholes = {}
    for writer in ("sync", "async"):
        cfg = cut_config(pipeline=True, local_backend="pallas", pipeline_depth=2,
                          checkpoint_async=writer == "async",
                          checkpoint_dir=os.path.join(root, "ckpt", writer))
        sim = Simulator(cfg, device="cuda")
        state = sim.init_state()
        reset_launches()
        (wholes[writer], history), syncs, sites = count_syncs(
            lambda: sim.run(state=state, verbose=False))
        launches = launch_counts()
        sim.close()
        ours = entry_states(sim)
        gaps = {r: host_state_gap(ours[r], theirs[r]) for r in ours}
        log(f"[pipeline] pallas depth 2, {writer} writer: entries {sorted(ours)}, max |d| from "
            f"run's entry of the round {gaps}; {syncs} host syncs over {len(history)} rounds "
            f"({syncs / len(history):.2f} a round, the saves' copies to the host) at "
            f"{dict(sites)}; launches {launches}")
        if max(ours) != 3 or (writer == "sync" and sorted(ours) != [1, 2, 3]):
            raise AssertionError(f"pipeline {writer} writer: entries {sorted(ours)}")
        if max(gaps.values()) > RUN_GAPS["pallas"]:
            raise AssertionError(f"pipeline {writer} writer: entries differ from run's {gaps}")
        require_kernel(f"pipeline {writer} writer", cfg, launches, len(history))

    cut_dir = os.path.join(root, "ckpt", "cut")
    Simulator(cut_config(pipeline=True, local_backend="pallas", pipeline_depth=2,
                         checkpoint_dir=cut_dir), device="cuda").run(num_rounds=2, verbose=False)
    resumed_sim = Simulator(cut_config(pipeline=True, local_backend="pallas", pipeline_depth=2,
                                       checkpoint_dir=cut_dir, resume=True), device="cuda")
    state = resumed_sim.load_or_init_state()
    reset_launches()
    resumed, rest = resumed_sim.run(state=state, verbose=False)
    launches = launch_counts()
    gap = max_param_gap(resumed["global_params"], wholes["sync"]["global_params"])
    seq = [(h["round"], h["broadcast"], h["ok"]) for h in rest]
    log(f"[pipeline] resume from round {state['completed_rounds']}: (round, broadcast, ok) "
        f"{seq}; resumed vs uninterrupted max |d params| {gap:.3e}; launches {launches}")
    if seq != [(3, 3, True)] or gap > RUN_GAPS["pallas"]:
        raise AssertionError(f"pipeline resume: {seq}, gap {gap:.3e}")
    require_kernel("pipeline resumed", resumed_sim.cfg, launches, len(rest))


def pipeline_hyper_run(workdir: str) -> None:
    """Phase 13 d: hyper config 2 (cut) under run and the pipeline."""
    label, config, cut = HYPER_RUNS[0]
    cfg = Config(**{**config, **cut, "log_path": workdir, "checkpoint_dir": workdir,
                    "pipeline_depth": 2})
    run_sim = Simulator(cfg, device="cuda")
    a, _ = run_sim.run(state=run_sim.init_state(), save_checkpoints=False, verbose=False)
    sim = Simulator(cfg.replace(pipeline=True), device="cuda")
    state = sim.init_state()
    reset_launches()
    t0 = time.perf_counter()
    (b, history), syncs, sites = count_syncs(lambda: sim.run(
        state=state, save_checkpoints=False, verbose=False))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    same = (torch.equal(a["hnet_params"], b["hnet_params"])
            and all(torch.equal(a["hyper_opt_state"][k], b["hyper_opt_state"][k])
                    for k in ("count", "m", "v")))
    log(f"[pipeline] hyper {label} depth 2: {len(history)} rounds ok="
        f"{[h['ok'] for h in history]} in {seconds:.3f} s; hypernetwork and Adam state equal "
        f"run's bit for bit: {same}; {syncs} host syncs ({syncs / len(history):.1f} a round) "
        f"at {dict(sites)}; launches {launches}")
    if not same:
        raise AssertionError("pipeline hyper: the hypernetwork differs from run's")
    require_kernel("pipeline hyper", cfg, launches, len(history))


def pipeline_stop_run(root: str) -> None:
    """Phase 13 e: depth 2 under pallas, 6 rounds asked, a hook that says
    "drain" once STOP_ROUNDS rounds are done."""
    cfg = cut_config(pipeline=True, local_backend="pallas", pipeline_depth=2, num_round=6,
                      checkpoint_dir=os.path.join(root, "stop"))
    sim = Simulator(cfg, device="cuda")
    calls = []

    def stop(done):
        calls.append(done)
        return "drain" if done >= STOP_ROUNDS else None

    state = sim.init_state()
    reset_launches()
    state, history = sim.run(state=state, verbose=False, stop=stop)
    launches = launch_counts()
    rounds = [e["round"] for e in sim.checkpoints.read_manifest()["entries"]]
    log(f"[pipeline] stop at {STOP_ROUNDS} round(s): rounds {[h['round'] for h in history]} "
        f"resolved, completed {state['completed_rounds']}, manifest rounds {rounds}, hook "
        f"called at {calls}, _stop_reason {sim._stop_reason!r}; launches {launches}")
    expect = list(range(1, STOP_ROUNDS + 3))
    if [h["round"] for h in history] != expect or rounds != expect[-3:]:
        raise AssertionError("pipeline stop: the rounds in flight did not resolve and save")
    if sim._stop_reason != "drain" or calls[-1] != STOP_ROUNDS:
        raise AssertionError(f"pipeline stop: reason {sim._stop_reason!r}, calls {calls}")
    require_kernel("pipeline stop", cfg, launches, len(history))


def pipeline_cli_run(workdir: str) -> None:
    """Phase 13 f: the server with --no-wait --pipeline-depth 2 on the
    cut config.yaml, in this process so that its launches are counted.
    The pipelined executor writes to app.log only a failed round's
    warning, as JAX's (its run has no start line and no validation
    line)."""
    path = surface_yaml(workdir)
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["server", "--config", path, "--no-wait", "--pipeline-depth", "2",
                       "--rounds", str(SURFACE_CUT["num-round"])])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(workdir, "app.log")) as fh:
        lines = [line.split(" - ", 1)[1] for line in fh.read().splitlines()]
    finished = f"Finished: {SURFACE_CUT['num-round']} successful rounds."
    log(f"[pipeline] server --no-wait --pipeline-depth 2 --rounds {SURFACE_CUT['num-round']}: "
        f"exit {rc} in {seconds:.3f} s (construction included); {finished!r} printed: "
        f"{finished in out.getvalue()}; app.log {lines}; launches {launches}")
    if rc != 0 or finished not in out.getvalue():
        raise AssertionError(f"pipeline cli: exit {rc}, output {out.getvalue()[-500:]!r}")
    if not all(re.fullmatch(r"WARNING - Round \d+ failed \(retry \d+\)", line)
               for line in lines):
        raise AssertionError(f"pipeline cli: app.log holds {lines}")
    require_kernel("pipeline cli", load_config(path), launches,
                   SURFACE_CUT["num-round"] + len(lines))


def pipeline_phase() -> dict:
    """Phase 13: runs a-f.  Returns the launches of a's depth runs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        marks = [time.perf_counter()]
        launches = pipeline_depth_runs()
        marks.append(time.perf_counter())
        pipeline_fault_runs(root)
        marks.append(time.perf_counter())
        pipeline_checkpoint_runs(root)
        marks.append(time.perf_counter())
        pipeline_hyper_run(root)
        marks.append(time.perf_counter())
        pipeline_stop_run(root)
        marks.append(time.perf_counter())
        cli_dir = os.path.join(root, "cli")
        os.makedirs(cli_dir)
        pipeline_cli_run(cli_dir)
        marks.append(time.perf_counter())
        log("[phase 13] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcdef", marks, marks[1:])))
    finally:
        shutil.rmtree(root)
    return launches


def read_events(directory: str) -> list:
    """A run's ``events.jsonl``, every event held to ``validate_event``."""
    with open(os.path.join(directory, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    bad = [(e.get("kind"), validate_event(e)) for e in events if validate_event(e)]
    if bad:
        raise AssertionError(f"{directory}: events fail the schema: {bad[:3]}")
    return events


def telemetry_run(backend: str, how: str, root: str, enabled: bool, turn: int,
                  rounds: int | None = None):
    """Phase 14 a's run of config 4 (cut; ``rounds`` rounds if given)
    through ``how`` with telemetry ``enabled``, under ``count_syncs``:
    (Simulator, state, history, wall seconds, launches, host syncs, their
    sites, the seconds of the run's end: ``_emit_run_end``, which writes
    the counters, ``run_end`` and the trace, and ``_append_ledger_record``)."""
    directory = os.path.join(root, f"{backend}-{how}-{turn}-{'on' if enabled else 'off'}")
    cfg = cut_config(local_backend=backend, log_path=directory, checkpoint_dir=directory,
                     pipeline=how == "pipeline", pipeline_depth=TELEMETRY_DEPTH,
                     telemetry=TelemetryConfig(enabled=enabled,
                                               ledger_dir=os.path.join(root, "ledger")),
                     **SEQUEL_CUT, **({} if rounds is None else {"num_round": rounds}))
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    end = {}
    for name in ("_emit_run_end", "_append_ledger_record"):
        def timed(*args, _real=getattr(sim, name), _name=name):
            t = time.perf_counter()
            try:
                return _real(*args)
            finally:
                end[_name] = time.perf_counter() - t
        setattr(sim, name, timed)
    if how == "run_fast":
        def go():
            return sim.run_fast(state=state, chunk_size=cfg.num_round, save_checkpoints=False,
                                verbose=False)
    else:
        def go():
            return sim.run(state=state, save_checkpoints=False, verbose=False)
    reset_launches()
    t0 = time.perf_counter()
    (state, history), syncs, sites = count_syncs(go)
    wall = time.perf_counter() - t0
    return sim, state, history, wall, launch_counts(), syncs, sites, end


def telemetry_executor_runs(root: str) -> dict:
    """Phase 14 a: each executor under each backend with telemetry off,
    on, on and off, in that order (the runs' s/round in turns).  Gates on
    the first run with it on and the first with it off: every event
    valid, the kinds in JAX's order, the params bit for bit, the host
    syncs of phases 12-13 (a chunk SYNCS_PER_CHUNK, a pipelined run none
    besides its event waits) equal on and off, nothing written off, the
    kernel launched.  Then a pallas ``run`` of TELEMETRY_LONG_ROUNDS in
    the same turns, and each run's end with telemetry on, timed on its
    own.  Returns the launches of the gated run with telemetry on."""
    total = Counter()
    card = card_line()
    for backend in ("pallas", "xla"):
        for how in TELEMETRY_EXECUTORS:
            off_sim, off, _, wall_off, _, syncs_off, _, _ = telemetry_run(
                backend, how, root, False, 0)
            sim, on, history, wall_on, launches, syncs, sites, end = telemetry_run(
                backend, how, root, True, 0)
            wall_on2, end2 = telemetry_run(backend, how, root, True, 1)[3::4]
            wall_off2 = telemetry_run(backend, how, root, False, 1)[3]
            written = [name for name in ("events.jsonl", "trace.json", "ledger")
                       if os.path.exists(os.path.join(off_sim.cfg.log_path, name))]
            total.update(launches)
            label = f"telemetry {backend} {how}"
            n = len(history)
            events = read_events(sim.cfg.log_path)
            kinds = [e["kind"] for e in events]
            middle = (["chunk"] if how == "run_fast" else []) + ["round"] * n
            # the cost model (on with telemetry, as in JAX) profiles each
            # program at its first dispatch, before the first round's event
            profiles = ["program_profile"] * (2 if how == "run" else 1)
            expect = ["run_header"] + profiles + middle + ["counters", "run_end", "ledger"]
            gap = max_param_gap(on["global_params"], off["global_params"])
            equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(on["global_params"]),
                                                          tree_leaves(off["global_params"])))
            log(f"[telemetry] {backend} {how}: {len(events)} events, kinds {kinds}; s/round "
                f"in turns off, on, on, off: {wall_off / n:.4f}, {wall_on / n:.4f}, "
                f"{wall_on2 / n:.4f}, {wall_off2 / n:.4f}; {run_end_line(end, end2, n)}; "
                f"params on vs off "
                f"max |d| {gap:.3e}; host syncs on {syncs} (at {dict(sites)}), off "
                f"{syncs_off}; launches {launches} ({card})")
            if kinds != expect:
                raise AssertionError(f"{label}: kinds {kinds}, expected {expect}")
            if not equal:
                raise AssertionError(f"{label}: telemetry changed the params")
            if written:
                raise AssertionError(f"{label}: telemetry off wrote {written}")
            if (how == "run_fast" and syncs != SYNCS_PER_CHUNK) or (how == "pipeline" and syncs):
                raise AssertionError(f"{label}: {syncs} host syncs at {dict(sites)}")
            if syncs != syncs_off:
                raise AssertionError(f"{label}: telemetry changed the host syncs, {syncs} "
                                     f"against {syncs_off}")
            require_kernel(label, sim.cfg, launches, n)
    long_runs = [telemetry_run("pallas", "run", root, enabled, turn, TELEMETRY_LONG_ROUNDS)
                 for turn, enabled in enumerate((False, True, True, False))]
    walls = ", ".join(f"{r[3] / TELEMETRY_LONG_ROUNDS:.4f}" for r in long_runs)
    log(f"[telemetry] pallas run of {TELEMETRY_LONG_ROUNDS} rounds: s/round in turns off, on, "
        f"on, off: {walls}; {run_end_line(long_runs[1][7], long_runs[2][7], TELEMETRY_LONG_ROUNDS)}"
        f" ({card})")
    return dict(total)


def run_end_line(end: dict, end2: dict, n: int) -> str:
    """The run's end with telemetry on, in the two runs with it on: the
    counters, ``run_end`` and the trace, the ledger append, and what the
    two cost a round of an n-round run."""
    parts = [(end[k], end2[k]) for k in ("_emit_run_end", "_append_ledger_record")]
    return (f"the run's end with it on: counters, run_end and trace {1e3 * parts[0][0]:.2f} and "
            f"{1e3 * parts[0][1]:.2f} ms, ledger append {1e3 * parts[1][0]:.2f} and "
            f"{1e3 * parts[1][1]:.2f} ms, {1e3 * sum(map(sum, parts)) / 2 / n:.2f} ms a round")


def telemetry_fault_runs(root: str) -> None:
    """Phase 14 b: phase 11a's fault plan under run (pallas) with
    checkpoints, then a resume past its torn entry; phase 13b's demotion
    plan under the pipeline.  Gates: their fault, retry, checkpoint,
    resume and degrade events."""
    plan = parse_fault_plan(FAULT_PLAN)
    whole, cut = os.path.join(root, "faults", "whole"), os.path.join(root, "faults", "cut")
    sim = Simulator(cut_config(local_backend="pallas", log_path=whole, checkpoint_dir=whole,
                               faults=plan), device="cuda")
    sim.run(state=sim.init_state(), verbose=False)
    Simulator(cut_config(local_backend="pallas", log_path=cut, checkpoint_dir=cut, faults=plan),
              device="cuda").run(num_rounds=2, verbose=False)
    resumed = Simulator(cut_config(local_backend="pallas", log_path=cut, checkpoint_dir=cut,
                                   faults=plan, resume=True), device="cuda")
    resumed.run(verbose=False)
    events = read_events(whole)
    faults = [(e["fault"], e["round"]) for e in events if e["kind"] == "fault"]
    retries = [(e["round"], e["retries"], e.get("reason", "round")) for e in events
               if e["kind"] == "retry"]
    checkpoints = [e["round"] for e in events if e["kind"] == "checkpoint"]
    # the cut directory's log holds the 2-round run, then the resumed one
    resumes = [(e["round"], len(e["rejected"])) for e in read_events(cut)
               if e["kind"] == "resume"]
    log(f"[telemetry] pallas fault plan under run: fault events {faults}; retry events "
        f"{retries}; checkpoint events for rounds {checkpoints}; resume events (round, "
        f"rejected entries) {resumes}")
    if faults.count(("ckpt_write_error", 1)) != 2 or ("nan_storm", 2) not in faults:
        raise AssertionError(f"telemetry faults: fault events {faults}")
    if (2, 1, "round") not in retries or checkpoints != [1, 2, 3] or resumes != [(1, 1)]:
        raise AssertionError(f"telemetry faults: retries {retries}, checkpoints "
                             f"{checkpoints}, resumes {resumes}")

    demote = os.path.join(root, "demote")
    sim = Simulator(cut_config(local_backend="pallas", log_path=demote,
                               faults=parse_fault_plan(DEMOTE_PLAN), pipeline=True,
                               pipeline_depth=DEMOTE_DEPTH, pipeline_demote_after=2,
                               pipeline_repromote_after=2), device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    degrades = [(e["state"], e["round"], e.get("configured_depth", e.get("depth")))
                for e in read_events(demote) if e["kind"] == "degrade"]
    counters = sim.telemetry.counters.snapshot() if sim.telemetry.enabled else {}
    log(f"[telemetry] pallas {DEMOTE_PLAN} at depth {DEMOTE_DEPTH}: degrade events (state, "
        f"round, depth) {degrades}")
    if [d[0] for d in degrades] != ["demoted", "repromoted"]:
        raise AssertionError(f"telemetry demotion: degrade events {degrades} {counters}")


def attribution_runs(root: str) -> None:
    """Phase 14 c: ATTRIBUTION_ROUNDS rounds of config 4 (cut, pallas)
    under each of ATTRIBUTION_MODES; the attacking round's attribution
    event names the round's active attackers (the 25 LIE clients)."""
    for mode in ATTRIBUTION_MODES:
        directory = os.path.join(root, "attribution", mode)
        sim = Simulator(cut_config(local_backend="pallas", mode=mode, log_path=directory,
                                   num_round=ATTRIBUTION_ROUNDS), device="cuda")
        _, history = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
        events = [e for e in read_events(directory) if e["kind"] == "attribution"]
        attackers = sorted(i for g in sim.attack_groups for i in g.indices)
        last = events[-1] if events else {}
        log(f"[telemetry] {mode}: {len(events)} attribution events; the attacking round's "
            f"attackers {len(last.get('attackers', []))}, kept {len(last.get('kept', []))}, "
            f"removed {len(last.get('removed', []))} (of them attackers "
            f"{len(set(last.get('removed', [])) & set(attackers))}); rounds ok "
            f"{[h['ok'] for h in history]}")
        if len(events) != ATTRIBUTION_ROUNDS or events[0]["attackers"] \
                or last["attackers"] != attackers:
            raise AssertionError(f"attribution {mode}: events {[e['attackers'] for e in events]}"
                                 f", expected the attackers {attackers} in the last round only")


def ledger_auto_run(root: str) -> None:
    """Phase 14 d: a's pipelined config (pallas) again under
    ``pipeline_depth: auto``, under torch.profiler: the depth it reads
    from a's ledger records against ``auto_depth_from_records``, the
    records' round_device_time and host_resolution_latency, and the run's
    device-busy seconds a round."""
    ledger = os.path.join(root, "ledger")
    directory = os.path.join(root, "auto")
    cfg = cut_config(local_backend="pallas", log_path=directory, pipeline=True,
                     pipeline_depth="auto", telemetry=TelemetryConfig(ledger_dir=ledger),
                     **SEQUEL_CUT)
    sim = Simulator(cfg, device="cuda")
    records = LedgerStore(ledger).records(fingerprint=sim.checkpoints.fingerprint)
    expect, info = engine.auto_depth_from_records(records, sim.checkpoints.fingerprint)
    state = sim.init_state()
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, history = sim.run(state=state, save_checkpoints=False, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    busy = busy_us(device) / 1e6 / len(history)
    pipelined = [r for r in records if r["executor"] == "pipelined"]
    if not pipelined:
        raise AssertionError(f"auto depth: no pipelined record among {len(records)} in {ledger}")
    log(f"[telemetry] pallas pipeline_depth auto: depth {sim._depth_resolved} from "
        f"{len(records)} ledger records of the fingerprint (executors "
        f"{[r['executor'] for r in records]}; auto_depth_from_records {expect}, {info}); "
        f"the pipelined record's round_device_time {pipelined[-1]['round_device_time']} s, "
        f"host_resolution_latency {pipelined[-1]['host_resolution_latency']} s; this run "
        f"under torch.profiler: wall {wall / len(history):.4f} s/round, device busy "
        f"{busy:.4f} s/round ({card_line()})")
    if sim._depth_resolved != min(expect or 1, engine.AUTO_DEPTH_CAP):
        raise AssertionError(f"auto depth {sim._depth_resolved}, expected {expect}")


def telemetry_phase() -> dict:
    """Phase 14: runs a-d.  Returns the launches of a's runs with
    telemetry on."""
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        marks = [time.perf_counter()]
        launches = telemetry_executor_runs(root)
        marks.append(time.perf_counter())
        telemetry_fault_runs(root)
        marks.append(time.perf_counter())
        attribution_runs(root)
        marks.append(time.perf_counter())
        ledger_auto_run(root)
        marks.append(time.perf_counter())
        log("[phase 14] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcd", marks, marks[1:])))
    finally:
        shutil.rmtree(root)
    return launches


def health_code(port: int) -> int:
    """``/healthz``'s status code (a 503 arrives as HTTPError)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def numerics_rows(events: list) -> list:
    return [e for e in events if e["kind"] == "metric" and e.get("metric") == "numerics"]


def numerics_run(backend: str, how: str, root: str, on: bool, turn: int):
    """Phase 15 a's run of config 4 (cut) through ``how`` with numerics
    ``on`` (window NUMERICS_WINDOW), under ``count_syncs``: (Simulator,
    state, history, wall seconds, launches, host syncs, their sites, the
    drains as (rows read, host ms))."""
    directory = os.path.join(root, f"{backend}-{how}-{turn}-{'on' if on else 'off'}")
    cfg = cut_config(local_backend=backend, log_path=directory, checkpoint_dir=directory,
                     pipeline=how == "pipeline", pipeline_depth=TELEMETRY_DEPTH,
                     telemetry=TelemetryConfig(numerics=on, numerics_window=NUMERICS_WINDOW,
                                               ledger_dir=os.path.join(root, "ledger")),
                     **SEQUEL_CUT)
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    drains = []
    if on:
        def timed_drain(num_state, _real=sim._numerics_drainer.drain):
            t = time.perf_counter()
            rows = _real(num_state)
            drains.append((rows, 1e3 * (time.perf_counter() - t)))
            return rows
        sim._numerics_drainer.drain = timed_drain
    if how == "run_fast":
        def go():
            return sim.run_fast(state=state, chunk_size=cfg.num_round, save_checkpoints=False,
                                verbose=False)
    else:
        def go():
            return sim.run(state=state, save_checkpoints=False, verbose=False)
    reset_launches()
    t0 = time.perf_counter()
    (state, history), syncs, sites = count_syncs(go)
    wall = time.perf_counter() - t0
    return sim, state, history, wall, launch_counts(), syncs, sites, drains


def numerics_step_inputs(sim: Simulator, params: dict, broadcast: int) -> tuple:
    """One attacked round's inputs to the numerics step on the card: the
    round step's client rows, sizes and loss, and the aggregate."""
    draws = sim.draw_round(torch.Generator(device=sim.device).manual_seed(broadcast))
    stacked, sizes, _, ok, loss = sim.round_step(params, sim.init_state()["prev_genuine"],
                                                 True, draws, broadcast)
    weights = torch.ones(sim.cfg.total_clients, device=sim.device) * (sizes > 0)
    new_global = sim.aggregate(params, stacked, sizes, weights, draws)
    torch.cuda.synchronize()
    return stacked, sizes, loss, bool(ok), new_global


def numerics_step_cost(sim: Simulator, params: dict, label: str) -> dict:
    """Phase 15 a: the numerics step on one round's inputs: its device
    launches and device-busy ms (torch.profiler), the host's ms issuing
    it, and the step's ms by CUDA events around it."""
    stacked, sizes, loss, ok, new_global = numerics_step_inputs(sim, params, 3)
    ring = sim._numerics.init_state()

    def step():
        return sim._numerics_step(ring, params, new_global, stacked, sizes, loss, ok, 3)

    step_ms = time_ms(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    if not device:
        raise AssertionError(f"numerics {label}: torch.profiler recorded no device activity")
    return {"launches": len(device), "busy_ms": busy_us(device) / 1e3, "host_ms": host_ms,
            "events_ms": step_ms}


def numerics_card_vs_cpu(sim: Simulator, params: dict) -> None:
    """Phase 15 b: one attacked round's row on the card against
    ``compute_row`` on the CPU from the same inputs copied to the host."""
    stacked, sizes, loss, ok, new_global = numerics_step_inputs(sim, params, 3)
    prev_loss = torch.full((), 0.5, device=sim.device)
    card = sim._numerics.compute_row(params, params, new_global, stacked, sizes, prev_loss,
                                     loss, ok, 3).cpu().numpy()
    cpu = tmetrics.Numerics(sim._numerics.layout, ~sim.attacker_mask, sim.attacker_mask,
                            NUMERICS_WINDOW, device="cpu")
    def to_cpu(tree):
        return tree_map(lambda x: x.cpu(), tree)

    host = cpu.compute_row(to_cpu(params), to_cpu(params), to_cpu(new_global),
                           to_cpu(stacked), sizes.cpu(), prev_loss.cpu(), loss.cpu(), ok,
                           3).numpy()
    names = sim._numerics.layout.names
    k = len(names)
    errs = {}
    for name, a, b in zip(names, card[:k], host[:k]):
        if np.isnan(a) and np.isnan(b):
            continue
        errs[name] = abs(float(a) - float(b)) / abs(float(b)) if b else abs(float(a))
    worst = max(errs, key=errs.get)
    norms = torch.sqrt(sum(torch.sum(torch.square((x - p).float()).reshape(x.shape[0], -1), 1)
                           for x, p in zip(tree_leaves(stacked), tree_leaves(params))))
    edges = torch.tensor(tmetrics.HIST_EDGES, device=norms.device)
    near = norms[(torch.abs(norms[:, None] - edges[None, :]) <= NUMERICS_RTOL * edges).any(1)]
    same_hist = bool(np.array_equal(card[k:], host[k:]))
    gaps = ", ".join(f"{n}: {e:.1e}" for n, e in errs.items())
    log(f"[numerics] pallas broadcast 3's row, card against CPU: {k} gauges, worst relative "
        f"gap {errs[worst]:.3e} ({worst}: card {card[names.index(worst)]!r}, CPU "
        f"{host[names.index(worst)]!r}); gaps {{{gaps}}}; "
        f"histogram {card[k:].astype(int).tolist()} equal {same_hist}; norms within "
        f"{NUMERICS_RTOL:g} of an edge: {near.tolist()}")
    if errs[worst] > NUMERICS_RTOL:
        raise AssertionError(f"numerics card vs CPU: {worst} apart by {errs[worst]:.3e}")
    if not same_hist and not len(near):
        raise AssertionError(f"numerics card vs CPU: histograms {card[k:]} and {host[k:]}")


def numerics_executor_runs(root: str) -> tuple[dict, str]:
    """Phase 15 a and b: each executor under each backend with numerics
    off, on, on and off.  Gates on the first run on and the first off:
    the params bit for bit, one valid row a round in round order, the
    host syncs (a chunk SYNCS_PER_CHUNK, the pipeline none, run's
    on-run one more a drain), the kernel launched.  Returns the launches
    of the gated runs with numerics on, and the directory of the pallas
    run's events."""
    total = Counter()
    card = card_line()
    events_dir = None
    for backend in ("pallas", "xla"):
        for how in TELEMETRY_EXECUTORS:
            _, off, _, wall_off, _, syncs_off, _, _ = numerics_run(backend, how, root, False, 0)
            sim, on, history, wall_on, launches, syncs, sites, drains = numerics_run(
                backend, how, root, True, 0)
            wall_on2 = numerics_run(backend, how, root, True, 1)[3]
            wall_off2 = numerics_run(backend, how, root, False, 1)[3]
            total.update(launches)
            label = f"numerics {backend} {how}"
            n = len(history)
            rows = numerics_rows(read_events(sim.cfg.log_path))
            equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(on["global_params"]),
                                                          tree_leaves(off["global_params"])))
            reads = sum(1 for r, _ in drains if r)
            log(f"[numerics] {backend} {how}: rows (round, broadcast, ok) "
                f"{[(e['round'], e['broadcast'], e['numerics']['ok']) for e in rows]}; s/round "
                f"in turns off, on, on, off: {wall_off / n:.4f}, {wall_on / n:.4f}, "
                f"{wall_on2 / n:.4f}, {wall_off2 / n:.4f}; params on vs off equal {equal}; "
                f"host syncs on {syncs} (at {dict(sites)}), off {syncs_off}; drains (rows, "
                f"ms) {[(r, round(ms, 3)) for r, ms in drains]}; launches {launches} ({card})")
            if [(e["round"], e["broadcast"]) for e in rows] != \
                    [(h["round"], h["broadcast"]) for h in history]:
                raise AssertionError(f"{label}: rows {rows}")
            if not equal:
                raise AssertionError(f"{label}: numerics changed the params")
            if (how == "run_fast" and syncs != SYNCS_PER_CHUNK) or (how == "pipeline" and syncs):
                raise AssertionError(f"{label}: {syncs} host syncs at {dict(sites)}")
            if syncs != syncs_off + (reads if how == "run" else 0):
                raise AssertionError(f"{label}: {syncs} host syncs on against {syncs_off} off "
                                     f"and {reads} drains")
            if how == "run" and [r for r, _ in drains] != [2, 1]:
                raise AssertionError(f"{label}: drains {drains}")
            require_kernel(label, sim.cfg, launches, n)
            if how == "run":
                cost = numerics_step_cost(sim, on["global_params"], label)
                log(f"[numerics] {backend} the numerics step on a round's inputs: "
                    f"{cost['launches']} device launches, device busy {cost['busy_ms']:.4f} ms, "
                    f"host issue {cost['host_ms']:.3f} ms, {cost['events_ms']:.4f} ms by CUDA "
                    f"events ({card})")
                if backend == "pallas":
                    events_dir = sim.cfg.log_path
                    numerics_card_vs_cpu(sim, on["global_params"])
    return dict(total), events_dir


def monitor_stall_run(root: str) -> None:
    """Phase 15 c: phase 11a's plan and monitor_stall@STALL_ROUND under
    run (pallas) with checkpoints, numerics on and the monitor on an
    ephemeral port."""
    directory = os.path.join(root, "stall")
    cfg = cut_config(local_backend="pallas", log_path=directory, checkpoint_dir=directory,
                     num_round=STALL_RUN_ROUNDS,
                     faults=parse_fault_plan(f"{FAULT_PLAN};monitor_stall@{STALL_ROUND}"),
                     telemetry=TelemetryConfig(numerics=True, monitor=True, monitor_port=0))
    sim = Simulator(cfg, device="cuda")
    fired, before, beats = [], [], []
    real_stall = sim.fault_injector.maybe_stall_monitor
    real_beat = sim.monitor.record_round

    def stall(round_no, monitor):
        real_stall(round_no, monitor)
        fired.append((round_no, health_code(monitor.port)))

    def beat(metrics, duration=None):
        t = time.perf_counter()
        real_beat(metrics, duration)
        beats.append(1e3 * (time.perf_counter() - t))

    def look(done):
        """The stop hook, consulted before each round: never stops."""
        before.append((done + 1, health_code(sim.monitor.port)))
        return False

    sim.fault_injector.maybe_stall_monitor = stall
    sim.monitor.record_round = beat
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, history = sim.run(state=sim.init_state(), verbose=False, stop=look)
        final = health_code(sim.monitor.port)
        counters = sim.telemetry.counters.snapshot()
    finally:
        sim.close()
    events = read_events(directory)
    stalls = [e for e in events if e["kind"] == "stall"]
    storm = [e for e in numerics_rows(events) if e["numerics"]["nonfinite_count"]]
    leaf_names = sim._numerics.layout.leaf_names
    first = [leaf_names[int(e["numerics"]["first_nonfinite_leaf"])] for e in storm]
    storm_rows = [(e["broadcast"], e["numerics"]["nonfinite_clients"],
                   e["numerics"]["nonfinite_count"], f) for e, f in zip(storm, first)]
    log(f"[monitor] pallas fault plan + monitor_stall@{STALL_ROUND}: ok "
        f"{[h['ok'] for h in history]}; /healthz right after each round's fault seam "
        f"{fired}, before each round {before}, after the run {final}; stall events "
        f"{[(e['rounds_completed'], e['threshold_seconds']) for e in stalls]}, stalls_detected "
        f"{counters.get('stalls_detected')}; the storm's rows (broadcast, non-finite clients, "
        f"blocks, first layer) {storm_rows}; "
        f"record_round {min(beats):.3f}-{max(beats):.3f} ms ({card_line()})")
    if [e["broadcast"] for e in storm] != [2] or \
            storm[0]["numerics"]["nonfinite_clients"] != len(FAULT_STORM) or \
            first != [leaf_names[0]]:
        raise AssertionError(f"monitor stall run: storm rows {storm}")
    if dict(fired).get(STALL_ROUND) != 503 or len(stalls) != 1 \
            or counters.get("stalls_detected") != 1:
        raise AssertionError(f"monitor stall run: /healthz {fired}, stalls {stalls}")
    if dict(before).get(STALL_ROUND + 1) != 200 or final != 200:
        raise AssertionError(f"monitor stall run: /healthz before rounds {before}, after {final}")


def monitor_demotion_run(root: str, events_dir: str) -> None:
    """Phase 15 d: phase 13b's demotion plan at DEMOTE_DEPTH with the
    monitor and numerics on: /metrics' depth gauge at each heartbeat,
    /last-round's numerics gauges, then ``watch --once`` and ``metrics
    --numerics`` (on a's pallas run) as their own processes."""
    directory = os.path.join(root, "demote")
    cfg = cut_config(local_backend="pallas", log_path=directory,
                     faults=parse_fault_plan(DEMOTE_PLAN), pipeline=True,
                     pipeline_depth=DEMOTE_DEPTH, pipeline_demote_after=2,
                     pipeline_repromote_after=2,
                     telemetry=TelemetryConfig(numerics=True, monitor=True, monitor_port=0))
    sim = Simulator(cfg, device="cuda")
    depths, beats = [], []
    real_beat = sim.monitor.record_round

    def beat(metrics, duration=None):
        t = time.perf_counter()
        real_beat(metrics, duration)
        beats.append(1e3 * (time.perf_counter() - t))
        _, text = cli._http_get_text(f"http://127.0.0.1:{sim.monitor.port}/metrics")
        depths.append(int(cli._parse_prom(text)["attackfl_pipeline_depth"]))

    sim.monitor.record_round = beat
    try:
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            _, history = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
        launches = launch_counts()
        url = f"http://127.0.0.1:{sim.monitor.port}"
        # the last heartbeat precedes the re-promotion it completes
        _, text = cli._http_get_text(url + "/metrics")
        depths.append(int(cli._parse_prom(text)["attackfl_pipeline_depth"]))
        _, last = cli._http_get_json(url + "/last-round")
        watch = subprocess.run([sys.executable, "-m", "attackfl_tpu_torch", "watch", url,
                                "--once"], cwd=REPO, capture_output=True, text=True,
                               timeout=120)
    finally:
        sim.close()
    report = subprocess.run([sys.executable, "-m", "attackfl_tpu_torch", "metrics", events_dir,
                             "--numerics"], cwd=REPO, capture_output=True, text=True,
                            timeout=120)
    transitions = [d for i, d in enumerate(depths) if i == 0 or d != depths[i - 1]]
    gauges = last.get("numerics") or {}
    log(f"[monitor] pallas {DEMOTE_PLAN} at depth {DEMOTE_DEPTH}: ok {[h['ok'] for h in history]};"
        f" attackfl_pipeline_depth at each heartbeat and after the run {depths}; /last-round "
        f"numerics "
        f"{len(gauges)} gauges (update_norm_all_p95 {gauges.get('update_norm_all_p95')}); "
        f"record_round {min(beats):.3f}-{max(beats):.3f} ms; launches {launches}; watch --once "
        f"exit {watch.returncode}: {watch.stdout.strip()!r}; metrics --numerics exit "
        f"{report.returncode}, {len(report.stdout.splitlines())} lines ({card_line()})")
    if transitions != [DEMOTE_DEPTH, 0, DEMOTE_DEPTH]:
        raise AssertionError(f"monitor demotion: depth gauge {depths}")
    if "update_norm_all_p95" not in gauges or last.get("pipeline_depth") != DEMOTE_DEPTH:
        raise AssertionError(f"monitor demotion: /last-round {last}")
    if watch.returncode != 0 or "unorm_p95=" not in watch.stdout \
            or f"depth={DEMOTE_DEPTH}" not in watch.stdout:
        raise AssertionError(f"watch --once: exit {watch.returncode} {watch.stdout!r} "
                             f"{watch.stderr[-2000:]!r}")
    if report.returncode != 0 or "rounds with numerics: 3" not in report.stdout:
        raise AssertionError(f"metrics --numerics: exit {report.returncode} {report.stdout!r} "
                             f"{report.stderr[-2000:]!r}")
    require_kernel("monitor demotion", sim.cfg, launches, len(history))


def numerics_hyper_run(root: str) -> None:
    """Phase 15 e: hyper config 2 (cut) under run with numerics on and
    off."""
    label, config, cut = HYPER_RUNS[0]
    states, rows = [], []
    for on in (True, False):
        directory = os.path.join(root, f"hyper-{on}")
        sim = Simulator(Config(**{**config, **cut, "log_path": directory,
                                  "telemetry": TelemetryConfig(numerics=on)}), device="cuda")
        reset_launches()
        state, history = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
        launches = launch_counts()
        states.append(state)
        if on:
            rows = numerics_rows(read_events(directory))
    a, b = states
    same = (torch.equal(a["hnet_params"], b["hnet_params"])
            and all(torch.equal(a["hyper_opt_state"][k], b["hyper_opt_state"][k])
                    for k in ("count", "m", "v")))
    gauges = [(e["round"], e["numerics"]["update_norm_all_p95"], e["numerics"]["global_drift"])
              for e in rows]
    log(f"[numerics] hyper {label}: rows (round, update_norm_all_p95, global_drift) {gauges}"
        f"; hypernetwork and Adam state with numerics on and off equal bit for bit: {same}; "
        f"launches {launches}")
    if [e["round"] for e in rows] != [h["round"] for h in history] or not same:
        raise AssertionError(f"numerics hyper: rows {rows}, equal {same}")
    require_kernel("numerics hyper", sim.cfg, launches, len(history))


def numerics_phase() -> dict:
    """Phase 15: runs a-e.  Returns the launches of a's runs with
    numerics on."""
    root = tempfile.mkdtemp(prefix="chip_smoke_numerics_")
    try:
        marks = [time.perf_counter()]
        launches, events_dir = numerics_executor_runs(root)
        marks.append(time.perf_counter())
        monitor_stall_run(root)
        marks.append(time.perf_counter())
        monitor_demotion_run(root, events_dir)
        marks.append(time.perf_counter())
        numerics_hyper_run(root)
        marks.append(time.perf_counter())
        log("[phase 15] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip(("a+b", "c", "d", "e"), marks, marks[1:])))
    finally:
        shutil.rmtree(root)
    return launches


def http_get(port: int, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def trace_rows(path: str) -> list:
    """A window's trace, every event."""
    with gzip.open(path, "rb") as fh:
        return json.load(fh)["traceEvents"]


def label_check(events: list, rows: list) -> tuple[int, int]:
    """The kernel, memcpy and memset rows launched inside a
    ``record_function`` label of the engine, found from the trace's own
    spans (a row reaches its launch by its correlation), and how many of
    them the miner's ``rows`` (``_device_ops``) attribute to no
    program."""
    labels = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] + e["dur"] / 2 for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    inside = set()
    for i, e in enumerate(e for e in events
                          if e.get("ph") == "X" and e.get("cat") in
                          ("kernel", "gpu_memcpy", "gpu_memset")):
        t = launch.get((e.get("args") or {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in labels):
            inside.add(i)
    unknown = sum(1 for i, row in enumerate(rows) if i in inside and row[2] == "<unknown>")
    return len(inside), unknown


def least_lead_us(events: list) -> float | None:
    """The least start of a device row after its launch's on the trace's
    clock, which the card cannot make negative: below 0 the profiler's
    device clock runs ahead of its host clock."""
    starts = {(e.get("args") or {}).get("correlation"): e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in mine._LAUNCH_ROWS}
    leads = [e["ts"] - starts[c] for e in events
             if e.get("ph") == "X" and e.get("cat") in mine._CUDA_ROWS
             and (c := (e.get("args") or {}).get("correlation")) in starts]
    return round(min(leads), 3) if leads else None


def hotspot_run(backend: str, how: str, root: str, on: bool) -> dict:
    """Phase 16 a's run of config 4 (cut) through ``how`` with the window
    HOTSPOT_WINDOW, the cost model and the monitor ``on``, or with none of
    them, under ``sync_log``: the run, its host syncs, the syncs the
    window's open and close made themselves, the kernel launches between
    them, and with ``on`` the monitor's answers."""
    directory = os.path.join(root, f"{backend}-{how}-{'on' if on else 'off'}")
    tel = TelemetryConfig(hotspots=HOTSPOT_WINDOW if on else "", costmodel=on, monitor=on,
                          monitor_port=0, ledger_dir=os.path.join(root, "ledger"))
    cfg = cut_config(local_backend=backend, log_path=directory, checkpoint_dir=directory,
                     pipeline=how == "pipeline", pipeline_depth=TELEMETRY_DEPTH, telemetry=tel,
                     **SEQUEL_CUT)
    sim = Simulator(cfg, device="cuda")
    state = sim.init_state()
    window, marks = sim._hotspots, {}

    def seam(name, real, caught):
        def wrapped(*args, **kwargs):
            was, before, launches = window.profiling, len(syncs_of(caught)), launch_counts()
            real(*args, **kwargs)
            if window.profiling != was:
                marks[name] = {"launches": launches, "syncs": len(syncs_of(caught)) - before}
        return wrapped

    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()), sync_log() as caught:
        window.maybe_start = seam("open", window.maybe_start, caught)
        window.maybe_stop = seam("close", window.maybe_stop, caught)
        t0 = time.perf_counter()
        if how == "run_fast":
            state, history = sim.run_fast(state=state, chunk_size=cfg.num_round,
                                          save_checkpoints=False, verbose=False)
        else:
            state, history = sim.run(state=state, save_checkpoints=False, verbose=False)
        wall = time.perf_counter() - t0
        syncs = syncs_of(caught)
    out = {"sim": sim, "state": state, "history": history, "wall": wall,
           "launches": launch_counts(), "syncs": len(syncs),
           "sites": Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in syncs),
           "marks": marks, "dir": directory}
    if on:
        port = sim.monitor.port
        out["monitor"] = {path: http_get(port, path)
                          for path in ("/programs", "/hotspots", "/metrics")}
        out["spans"] = list(sim.telemetry.tracer._events)
    sim.close()
    return out


def hotspot_window_checks(backend: str, how: str, run: dict, off: dict) -> dict:
    """Phase 16 a's gates on one windowed run against its run with no
    window: one valid ``ok`` window of the executor's seam whose books
    close, the port's kernel rows by name equal to its launches over the
    window, in the category the tests fix and under the executor's label,
    no row launched inside a label left to no program, the params bit for
    bit, the host syncs outside the window's own those of the run without
    one.  Returns the window's ``hotspot`` event."""
    label = f"hotspots {backend} {how}"
    events = read_events(run["dir"])
    windows = [e for e in events if e["kind"] == "hotspot"]
    if len(windows) != 1 or windows[0]["status"] != "ok" or not windows[0]["books_close"] \
            or windows[0]["program"] != HOTSPOT_SEAM[how]:
        raise AssertionError(f"{label}: hotspot events {windows}")
    report = windows[0]
    events = trace_rows(os.path.join(run["dir"], report["trace"]))
    device_rows = mine._device_ops(events, "cuda")
    kernel = BACKEND_KERNEL[backend]
    name, category = KERNEL_ROWS[kernel]
    rows = [{"program": program, "category": mine.op_category(op)}
            for _, _, program, op, _ in device_rows if op == name]
    launched = run["marks"]["close"]["launches"][kernel] - run["marks"]["open"]["launches"][kernel]
    labelled, unknown = label_check(events, device_rows)
    window_syncs = run["marks"]["open"]["syncs"] + run["marks"]["close"]["syncs"]
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(run["state"]["global_params"]),
                                                  tree_leaves(off["state"]["global_params"])))
    n = len(run["history"])
    top = ", ".join(f"{r['name']} ({r['category']}, {r['program']}) {r['self_us']:.1f} us "
                    f"{r['share']:.1%}" for r in report["top_ops"][:3])
    timings = run["sim"]._hotspots.timings
    log(f"[hotspots] {backend} {how}: window {report['round_first']}-"
        f"{report['round_last']} ok, {report['lanes']} lanes, host_bound_fraction "
        f"{report['host_bound_fraction']} ({report['classification']}), busy "
        f"{report['device_busy_us'] / 1e3:.3f} ms of {report['wall_us'] / 1e3:.3f} ms; top "
        f"{top}; {name} rows {len(rows)} against {launched} launches in "
        f"the window, under {sorted({r['program'] for r in rows})} (the least device start "
        f"after its launch {least_lead_us(events)} us); {labelled} device rows "
        f"launched inside a label, {unknown} of them unattributed; open "
        f"{timings['open_ms']:.1f} ms, close {timings['close_ms']:.1f} ms, export "
        f"{timings['export_ms']:.1f} ms; s/round with the window and the cost model "
        f"{run['wall'] / n:.4f}, with neither {off['wall'] / n:.4f}; host syncs "
        f"{run['syncs']} (the window's open {run['marks']['open']['syncs']} and close "
        f"{run['marks']['close']['syncs']}) against {off['syncs']}; params equal {equal}")
    if len(rows) != launched or not launched:
        raise AssertionError(f"{label}: {name} rows {rows}, {launched} launches in the window")
    if any(r["category"] != category or r["program"] not in HOTSPOT_LABELS[how] for r in rows):
        raise AssertionError(f"{label}: {name} rows {rows}")
    if unknown or not labelled:
        raise AssertionError(f"{label}: {unknown} of {labelled} labelled rows unattributed")
    if not equal:
        raise AssertionError(f"{label}: the window or the cost model changed the params")
    if run["syncs"] - window_syncs != off["syncs"]:
        raise AssertionError(f"{label}: {run['syncs']} host syncs ({window_syncs} the "
                             f"window's) at {dict(run['sites'])}, {off['syncs']} without it")
    if (how == "run_fast" and off["syncs"] != SYNCS_PER_CHUNK) or (how == "pipeline"
                                                                  and off["syncs"]):
        raise AssertionError(f"{label}: {off['syncs']} host syncs without a window")
    return report


def profile_checks(backend: str, how: str, run: dict) -> dict:
    """Phase 16 b's gates on one run's ``program_profile`` events: the
    executor's programs, valid, with the dispatch's memory; their counted
    dispatches' host ms.  Returns the profiles by name."""
    events = read_events(run["dir"])
    profiles = {e["program"]: e for e in events if e["kind"] == "program_profile"}
    expect = set(HOTSPOT_LABELS[how])
    if set(profiles) != expect or any(p["memory"]["peak"] <= 0 for p in profiles.values()):
        raise AssertionError(f"profiles {backend} {how}: {profiles}")
    if how == "run_fast" and profiles[HOTSPOT_LABELS[how][0]]["rounds_per_dispatch"] != ROUNDS[1]:
        raise AssertionError(f"profiles {backend} {how}: rounds_per_dispatch {profiles}")
    return profiles


def cost_model_checks(runs: dict, root: str) -> None:
    """Phase 16 b: the programs of every windowed run; under pallas
    round_step's flops against the count of the same config on fake CPU
    tensors and K1's ``epoch_work`` in it; a second Simulator's profile;
    the ledger records' utilization on the H100; /programs, /hotspots and
    the gauges."""
    card = card_line()
    for (backend, how), run in runs.items():
        profiles = profile_checks(backend, how, run)
        counted = [e for e in run["spans"] if e["name"] == "costmodel"]
        log(f"[costmodel] {backend} {how}: " + "; ".join(
            f"{name} {p['flops'] / 1e9:.3f} GFLOP, {p['transcendentals'] / 1e6:.3f} M "
            f"transcendentals, {p['bytes_accessed'] / 1e9:.3f} GB, peak "
            f"{p['memory']['peak'] / 2 ** 30:.3f} GiB (argument "
            f"{p['memory']['argument'] / 2 ** 20:.1f} MiB, temp "
            f"{p['memory']['temp'] / 2 ** 20:.1f} MiB)" for name, p in sorted(profiles.items()))
            + "; the counter's bookkeeping " + ", ".join(
                f"{e['args']['program']} {e['dur'] / 1e3:.1f} ms over {e['args']['ops']} ops"
                for e in counted)
            + f" ({card})")
    sync = runs[("pallas", "run")]
    phases = sync["history"][1]["phases"]
    log(f"[costmodel] pallas run: round 2's uncounted train {phases['train'] * 1e3:.1f} ms, "
        f"aggregate {phases['aggregate'] * 1e3:.1f} ms")

    cfg = sync["sim"].cfg
    fake = costcli.count_sync_programs(cfg, "cpu")
    with unittest.mock.patch.object(tfs, "epoch_work", lambda C, nb, B: {"flops": 0, "bytes": 0}):
        without = costcli.count_sync_programs(cfg, "cpu")
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    k1 = cfg.epochs * tfs.epoch_work(cfg.total_clients, nb, cfg.batch_size)["flops"]
    card_step = [e for e in read_events(sync["dir"]) if e["kind"] == "program_profile"
                 and e["program"] == "round_step"][0]
    second = hotspot_run("pallas", "run", os.path.join(root, "second"), True)
    again = [e for e in read_events(second["dir"]) if e["kind"] == "program_profile"
             and e["program"] == "round_step"][0]
    keys = ("flops", "transcendentals", "bytes_accessed")
    log(f"[costmodel] pallas round_step: card {card_step['flops']} flops, the CPU's count on "
        f"fake tensors {fake['round_step']['flops']}, without K1's formula "
        f"{without['round_step']['flops']} (difference {fake['round_step']['flops'] - without['round_step']['flops']}, "
        f"{cfg.epochs} x epoch_work {k1}); bytes card {card_step['bytes_accessed']}, CPU "
        f"{fake['round_step']['bytes_accessed']}; a second Simulator "
        f"{[again[k] for k in keys]}")
    if card_step["flops"] != fake["round_step"]["flops"] \
            or fake["round_step"]["flops"] - without["round_step"]["flops"] != k1:
        raise AssertionError(f"round_step flops: card {card_step['flops']}, CPU {fake}, "
                             f"without K1 {without}, K1 {k1}")
    if any(again[k] != card_step[k] for k in keys):
        raise AssertionError(f"a second Simulator's round_step {again} against {card_step}")

    records, _ = LedgerStore(os.path.join(root, "ledger")).load()
    profiled = [r for r in records if r.get("programs")]
    for r in profiled:
        u = r["utilization"]
        log(f"[costmodel] ledger record {r['executor']} {r['fingerprint']}: utilization "
            f"{u['device_kind']}: flops {u.get('utilization_flops')}, bytes "
            f"{u.get('utilization_bytes')}; achieved {u['achieved_flops_per_sec'] / 1e12:.4f} "
            f"TFLOP/s, {u['achieved_bytes_per_sec'] / 1e12:.4f} TB/s over round_device_time "
            f"{r['round_device_time']} s; hotspots {r['hotspots']['status_counts']}, measured "
            f"{r['hotspots']['measured_round_device_s']} s a round, predicted "
            f"{r['hotspots']['predicted_round_device_s']} "
            f"(x{r['hotspots']['hotspot_prediction_error_factor']})")
        if "H100" not in u["device_kind"] or not all(
                0 < u.get(k, 0) <= UTILIZATION_CAP for k in ("utilization_flops",
                                                              "utilization_bytes")):
            raise AssertionError(f"ledger utilization {u}")
    if len(profiled) != len(runs):
        raise AssertionError(f"{len(profiled)} ledger records with programs, expected "
                             f"{len(runs)}")

    answers = sync["monitor"]
    programs = json.loads(answers["/programs"][1])
    windows = json.loads(answers["/hotspots"][1])["windows"]
    metrics = answers["/metrics"][1].decode()
    gauges = [line for line in metrics.splitlines()
              if line.startswith(("attackfl_program_", "attackfl_utilization",
                                  "attackfl_achieved", "attackfl_host_bound"))]
    log(f"[costmodel] the pallas run's monitor: /programs {sorted(programs['programs'])} "
        f"utilization {programs['utilization'].get('utilization_flops')} of the flops peak "
        f"over its median round; /hotspots {sorted(windows)}; gauges {gauges}")
    if set(programs["programs"]) != set(HOTSPOT_LABELS["run"]) or "sync" not in windows \
            or not any(g.startswith("attackfl_utilization") for g in gauges) \
            or not any(g.startswith("attackfl_host_bound_fraction") for g in gauges):
        raise AssertionError(f"monitor: {programs}, {windows}, {gauges}")


def hotspot_fail_open(root: str, off: dict) -> None:
    """Phase 16 c: the pallas run with its profile directory unwritable
    (a file where the directory goes): one ``unavailable`` window, its
    counter 1, and the params of a's run without a window."""
    directory = os.path.join(root, "unwritable")
    os.makedirs(directory)
    with open(os.path.join(directory, "profile"), "w"):
        pass
    sim = Simulator(cut_config(local_backend="pallas", log_path=directory,
                               telemetry=TelemetryConfig(hotspots=HOTSPOT_WINDOW), **SEQUEL_CUT),
                    device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    count = sim.telemetry.counters.get("hotspot_windows_unavailable")
    sim.close()
    windows = [(e["status"], e.get("reason")) for e in read_events(directory)
               if e["kind"] == "hotspot"]
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(state["global_params"]),
                                                  tree_leaves(off["state"]["global_params"])))
    log(f"[hotspots] pallas run with its profile directory unwritable: windows {windows}, "
        f"hotspot_windows_unavailable {count}, params equal to the run without a window "
        f"{equal}")
    if [w[0] for w in windows] != ["unavailable"] or count != 1 or not equal:
        raise AssertionError(f"fail-open: {windows}, counter {count}, params equal {equal}")


def config_raw(cfg: Config) -> dict:
    """A config of config 4's shape as the YAML schema's mapping: the
    server, learning, tpu and attack-clients sections."""
    attack = cfg.attacks[0]
    return {"server": {"num-round": cfg.num_round, "clients": cfg.total_clients,
                       "mode": cfg.mode, "model": cfg.model, "data-name": cfg.data_name,
                       "train-size": cfg.train_size, "test-size": cfg.test_size,
                       "genuine-rate": cfg.genuine_rate, "random-seed": cfg.random_seed,
                       "data-distribution": {"num-data-range": list(cfg.num_data_range)}},
            "learning": {"epoch": cfg.epochs, "batch-size": cfg.batch_size,
                         "learning-rate": cfg.lr, "clip-grad-norm": cfg.clip_grad_norm},
            "tpu": {"local-backend": cfg.local_backend},
            "attack-clients": [{"mode": attack.mode, "num-clients": attack.num_clients,
                                "attack-round": attack.attack_round,
                                "args": list(attack.args)}]}


def config_yaml(path: str, cfg: Config, log_path: str) -> str:
    """``cfg`` (of config 4's shape) as a config file logging into
    ``log_path``, held to ``cfg`` as ``load_config`` reads it back."""
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump({**config_raw(cfg), "log_path": log_path}, fh)
    if config_fingerprint(load_config(path)) != config_fingerprint(cfg):
        raise AssertionError(f"{path} does not read back as the config it was written from")
    return path


def config4_yaml(path: str, backend: str, log_path: str, **kw) -> str:
    """Config 4 (cut) under ``backend`` (and ``kw``'s epochs) as a config
    file, for the command lines."""
    return config_yaml(path, cut_config(local_backend=backend, **kw), log_path)


def command_line_checks(runs: dict, root: str) -> None:
    """Phase 16 d: ``hotspots show`` and ``diff`` on a's pallas run,
    ``metrics --programs``, ``cost estimate`` from a's ledger (the peer
    path) and from an empty one (the count on fake tensors), ``cost
    validate`` on a's ledger."""
    directory = runs[("pallas", "run")]["dir"]
    ledger = os.path.join(root, "ledger")
    path = config4_yaml(os.path.join(root, "config4.yaml"), "pallas", root, **SEQUEL_CUT)
    empty = os.path.join(root, "empty-ledger")
    os.makedirs(empty)
    commands = (["hotspots", "show", directory], ["hotspots", "diff", directory, directory],
                ["metrics", directory, "--programs"],
                ["cost", "estimate", "--config", path, "--dir", ledger, "--json"],
                ["cost", "estimate", "--config", path, "--dir", empty, "--json"],
                ["cost", "validate", "--dir", ledger])
    outs = []
    for argv in commands:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        outs.append((rc, buf.getvalue(), time.perf_counter() - t0))
        log(f"[commands] {' '.join(argv[:2])}: exit {rc} in {outs[-1][2]:.2f} s")
    for line in outs[0][1].splitlines()[:12] + outs[5][1].splitlines()[:4]:
        log(f"[commands]   {line}")
    peer, fresh = json.loads(outs[3][1]), json.loads(outs[4][1])
    log(f"[commands] cost estimate from a's ledger: {peer['method']}, "
        f"{peer.get('round_device_time')} s a round over {peer.get('peers')} peers; from an "
        f"empty ledger: {fresh['method']} ({fresh.get('reason')}, profile "
        f"{fresh.get('profile')})")
    if [rc for rc, _, _ in outs[:4]] != [0, 0, 0, 0] or peer["method"] != "peer":
        raise AssertionError(f"commands: exits {[rc for rc, _, _ in outs]}, estimate {peer}")
    if outs[4][0] not in (0, 2) or outs[5][0] not in (0, 1) or "error factor" not in outs[5][1]:
        raise AssertionError(f"commands: estimate {fresh}, validate {outs[5][:2]}")


def hotspot_hyper_run(root: str) -> None:
    """Phase 16 e: hyper config 2 (cut) under run with the window and the
    cost model, then with neither: one ``ok`` window, hyper_update
    profiled, the hypernetwork and its Adam state bit for bit."""
    label, config, cut = HYPER_RUNS[0]
    states = []
    for on in (True, False):
        directory = os.path.join(root, f"hyper-{on}")
        tel = TelemetryConfig(hotspots=HYPER_WINDOW if on else "", costmodel=on)
        sim = Simulator(Config(**{**config, **cut, "log_path": directory, "telemetry": tel}),
                        device="cuda")
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            state, history = sim.run(state=sim.init_state(), save_checkpoints=False,
                                     verbose=False)
        launches = launch_counts()
        sim.close()
        states.append(state)
        if on:
            events = read_events(directory)
            windows = [(e["status"], e["program"]) for e in events if e["kind"] == "hotspot"]
            programs = sorted(e["program"] for e in events if e["kind"] == "program_profile")
    a, b = states
    same = (torch.equal(a["hnet_params"], b["hnet_params"])
            and all(torch.equal(a["hyper_opt_state"][k], b["hyper_opt_state"][k])
                    for k in ("count", "m", "v")))
    log(f"[hotspots] hyper {label}: windows {windows}, programs {programs}; hypernetwork and "
        f"Adam state equal to the run with neither {same}; launches {launches}")
    if windows != [("ok", "sync")] or programs != ["hyper_update", "round_step"] or not same:
        raise AssertionError(f"hotspots hyper: windows {windows}, programs {programs}, "
                             f"equal {same}")
    require_kernel("hotspots hyper", sim.cfg, launches, len(history))


def compact_trace(src: str, dst: str) -> None:
    """``src``'s rows the miner reads, each with the fields it reads: the
    device rows and their launch rows with their correlation, the labels,
    the aten ops that are some launch's innermost, the profiler's span; a
    kernel's name as the miner shortens it."""
    events = trace_rows(src)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    wanted = {(e.get("args") or {}).get("correlation") for e in device}
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and (e.get("args") or {}).get("correlation") in wanted]
    ops: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            ops.setdefault((e["pid"], e["tid"]), []).append(e)
    keep = set()
    for lane, rows in ops.items():
        spans = [(e["ts"], e["ts"] + e["dur"], str(i)) for i, e in enumerate(rows)]
        queries = [(e["ts"] + e["dur"] / 2, j) for j, e in enumerate(launches)
                   if (e["pid"], e["tid"]) == lane]
        keep.update(id(rows[int(i)]) for i in mine._innermost(spans, queries).values())

    def slim(e):
        out = {k: e[k] for k in ("ph", "cat", "name", "pid", "tid", "ts", "dur")}
        if e["cat"] == "kernel":
            out["name"] = mine.kernel_short_name(e["name"])
        if "correlation" in (e.get("args") or {}):
            out["args"] = {"correlation": e["args"]["correlation"]}
        return out

    rows = [slim(e) for e in events if e.get("ph") == "X" and (
        e in device or e.get("cat") in ("user_annotation", "Trace") or id(e) in keep)]
    rows += [slim(e) for e in launches]
    with gzip.open(dst, "wt") as fh:
        json.dump({"traceEvents": rows}, fh, separators=(",", ":"))


def hotspot_fixtures(root: str, out_dir: str) -> None:
    """The CPU tests' golden traces: one config-4 (cut) round under each
    backend in a window, compacted to the rows the miner reads, which
    must mine as the whole trace does; written with their reports'
    top ops, categories and books to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    golden = {}
    for backend in ("pallas", "xla"):
        directory = os.path.join(root, f"fixture-{backend}")
        sim = Simulator(cut_config(local_backend=backend, log_path=directory, num_round=2,
                                   telemetry=TelemetryConfig(hotspots="2:2")), device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
        sim.close()
        (event,) = [e for e in read_events(directory) if e["kind"] == "hotspot"]
        name = f"config4_{backend}_round.cuda.trace.json.gz"
        dst = os.path.join(out_dir, name)
        compact_trace(os.path.join(directory, event["trace"]), dst)
        whole = mine.mine_trace(os.path.join(directory, event["trace"]))
        small = mine.mine_trace(dst)
        keys = ("top_ops", "categories", "books", "host_bound_fraction", "programs")
        if any(whole[k] != small[k] for k in keys):
            raise AssertionError(f"fixture {backend}: the compacted trace mines otherwise")
        golden[name] = {k: small[k] for k in keys}
        log(f"[fixtures] {name}: {os.path.getsize(dst)} bytes")
    with open(os.path.join(out_dir, "golden.json"), "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)


# phase 16f: windows of one K1 launch.  Each case opens EDGE_WINDOWS
# torch.profiler windows that launch K1 once (4 clients, one step):
# (seconds waited after the profiler starts, whether the card is
# synchronized before it stops, seconds waited then).  The first is
# HotspotCapture's own sequence; the second waits at both edges.  On the
# H100 such windows keep their row in a fresh process and lose it in most
# windows once 16a's windows have run, waits or not (PERF.md §7): the
# cause is open, so this is reported, not gated (16a's gate is exact)
EDGE_WINDOWS, EDGE_WAIT_S = 5, 0.05
EDGE_CASES = {"no wait": (0.0, False, 0.0), "both waits": (EDGE_WAIT_S, True, EDGE_WAIT_S)}


def window_edge_check(windows: int = EDGE_WINDOWS) -> dict:
    """Phase 16f: the K1 rows each case's windows lost, and the least
    device start after its launch (``least_lead_us``) over its windows.
    Returns {case: (lost, least lead)}."""
    from torch.profiler import ProfilerActivity, profile

    C = 4
    groups, batches, _ = kernel_inputs(C, 1, CONFIG4["batch_size"], C - 1)
    m, v = tfs.zeros_like_groups(groups), tfs.zeros_like_groups(groups)
    kw = step_kwargs(STEP_RATES)
    name = KERNEL_ROWS["fused_step"][0]
    tfs.run_epoch(groups, m, v, batches, 1, 0, **kw)
    torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="chip_smoke_edges_")
    out = {}
    try:
        for case, (open_s, sync, close_s) in EDGE_CASES.items():
            lost, leads = 0, []
            for i in range(windows):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.start()
                time.sleep(open_s)
                tfs.run_epoch(groups, m, v, batches, 1, 0, **kw)
                if sync:
                    torch.cuda.synchronize()
                time.sleep(close_s)
                prof.stop()
                path = os.path.join(root, f"{i}.json")
                prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh)["traceEvents"]
                rows = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                        and mine.kernel_short_name(str(e.get("name"))) == name]
                lost += 1 - len(rows)
                if (lead := least_lead_us(events)) is not None:
                    leads.append(lead)
            torch.cuda.synchronize()
            out[case] = (lost, min(leads) if leads else None)
            log(f"[hotspots] f {case} (wait {open_s * 1e3:.0f} ms after the start, "
                f"{'synchronize, ' if sync else ''}wait {close_s * 1e3:.0f} ms before the stop): "
                f"{lost} of {windows} K1 rows lost; the least device start after its launch "
                f"{out[case][1]} us")
    finally:
        shutil.rmtree(root)
    return out


def hotspots_phase(fixtures: str | None = None) -> dict:
    """Phase 16: runs a-e, f's windows of one launch (and the tests'
    golden traces into ``fixtures``).  Returns the launches of a's
    windowed runs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_hotspots_")
    total = Counter()
    try:
        marks = [time.perf_counter()]
        t0 = time.perf_counter()
        for _ in range(LABEL_REPS):
            with torch.profiler.record_function("round_step"):
                pass
        label_us = (time.perf_counter() - t0) / LABEL_REPS * 1e6
        log(f"[hotspots] a record_function label with no profiler: {label_us:.2f} us; a "
            f"synchronous round has 2, a chunk and a pipelined round 1")
        runs, offs = {}, {}
        for backend in ("pallas", "xla"):
            for how in TELEMETRY_EXECUTORS:
                run = hotspot_run(backend, how, root, True)
                off = hotspot_run(backend, how, root, False)
                hotspot_window_checks(backend, how, run, off)
                require_kernel(f"hotspots {backend} {how}", run["sim"].cfg, run["launches"],
                               len(run["history"]))
                total.update(run["launches"])
                runs[(backend, how)], offs[(backend, how)] = run, off
        marks.append(time.perf_counter())
        cost_model_checks(runs, root)
        marks.append(time.perf_counter())
        hotspot_fail_open(root, offs[("pallas", "run")])
        marks.append(time.perf_counter())
        command_line_checks(runs, root)
        marks.append(time.perf_counter())
        hotspot_hyper_run(root)
        marks.append(time.perf_counter())
        window_edge_check()
        marks.append(time.perf_counter())
        if fixtures:
            hotspot_fixtures(root, fixtures)
        log("[phase 16] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcdef", marks, marks[1:])))
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 17: the scenario matrix on config 4 (cut) under xla: LIE (z 0.74,
# from round 2) and `none` x fedavg, krum, median, FLTrust, gmm, hyper
# (HyperNetwork, no detector) x seeds 1, 2 over MATRIX_ROUNDS rounds in one
# chunk: 12 batched, 4 mapped, 4 host and 4 special cells.  Cut in depth
# from 3 rounds (a chunk of 3) and config 4 (cut)'s 2 local epochs,
# for the script's time beside phase 20, and from its 1,200-1,500 samples a
# client to 600-750 beside phase 21 and to MATRIX_DATA_RANGE (3 steps an
# epoch in place of 12) beside phase 23: every shape stays (the fold's
# 1,600 rows, its steps' batches), LIE still attacks (round 2), and the
# sweeps of phases 18 and 21 train at this depth too
MATRIX_ATTACKS = (AttackSpec(mode="LIE", num_clients=ATTACKERS, attack_round=2, args=(0.74,)),
                  AttackSpec(mode="none", num_clients=ATTACKERS, attack_round=2))
MATRIX_DEFENSES = ("fedavg", "krum", "median", "FLTrust", "gmm", "hyper")
MATRIX_SEEDS, MATRIX_ROUNDS, MATRIX_CHUNK, MATRIX_EPOCHS = (1, 2), 2, 2, 1
MATRIX_DATA_RANGE = (300, 375)
# FLTrust's root set, ROOT_SIZE test rows at ROOT_BATCH: K3 launches a
# broadcast of an FLTrust cell; the draws' file, which reads the card no more
ROOT_STEPS = -(-tround.ROOT_SIZE // tround.ROOT_BATCH)
ROOT_SEED_SITE = "attackfl_tpu_torch/data/partition.py"


def matrix_base(root: str, **kw) -> Config:
    """Config 4 (cut) under xla at MATRIX_EPOCHS and MATRIX_DATA_RANGE as
    a sweep's base: threefry, iid."""
    return cut_config(local_backend="xla", prng_impl="threefry2x32", partition="iid",
                      epochs=MATRIX_EPOCHS, num_data_range=MATRIX_DATA_RANGE,
                      log_path=root, checkpoint_dir=root, **kw)


def matrix_grid() -> GridSpec:
    return GridSpec(attacks=MATRIX_ATTACKS, defenses=MATRIX_DEFENSES, seeds=MATRIX_SEEDS,
                    rounds=MATRIX_ROUNDS, chunk=MATRIX_CHUNK)


def matrix_sweep(base: Config, stop=None) -> dict:
    """One sweep of ``matrix_grid`` on ``base``: its MatrixRun, final
    params and histories, and what its chunks did: each chunk's seconds,
    length, host syncs and their sites (under
    ``torch.cuda.set_sync_debug_mode("warn")``), the K3 launches and the
    allocator's peak at the end of the device cells, each fallback cell's
    seconds, the sweep's K3 launches and wall seconds."""
    sweep = MatrixRun(base, matrix_grid(), device="cuda")
    chunks, fallback, marks = [], {}, {}
    real_chunk, real_fallback = sweep._run_chunk, sweep._run_fallback_cells

    def chunk(cells, states, n, histories):
        t0 = time.perf_counter()
        out, syncs, sites = count_syncs(lambda: real_chunk(cells, states, n, histories))
        chunks.append({"seconds": time.perf_counter() - t0, "n": n, "cells": len(cells),
                       "syncs": syncs, "sites": sites})
        return out

    def fallbacks(*args):
        torch.cuda.synchronize()
        marks["device_launches"] = tfs.fill_masks.launches
        marks["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return real_fallback(*args)

    real_sim = matrix_exec.Simulator

    def timed_sim(cfg, device):
        sim = real_sim(cfg, device=device)
        for name in ("run", "run_fast"):
            def timed(*a, _real=getattr(sim, name), **k):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    fallback[cfg.mode] = fallback.get(cfg.mode, 0.0) + time.perf_counter() - t0
            setattr(sim, name, timed)
        return sim

    sweep._run_chunk, sweep._run_fallback_cells = chunk, fallbacks
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(matrix_exec, "Simulator", timed_sim), \
            contextlib.redirect_stdout(io.StringIO()):
        params, histories = sweep.run(stop=stop, verbose=False)
    wall = time.perf_counter() - t0
    sweep.close()
    return {"sweep": sweep, "params": params, "histories": histories, "chunks": chunks,
            "fallback_s": fallback, "wall": wall, "launches": tfs.fill_masks.launches, **marks}


def matrix_grid_state(out: dict) -> dict:
    """A sweep's final grid as host values: every device cell's state
    (``MatrixRun.host_state``), every fallback cell's final params."""
    sweep = out["sweep"]
    grid = sweep.host_state(sweep.state)
    for cell in sweep.fallback_cells:
        grid[cell.key] = {"params": out["params"].get(cell.key)}
    return grid


def first_difference(a, b, where: str = "") -> str | None:
    """The first leaf where two host trees differ, and by how much."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            return f"{where}: keys differ"
        for key in sorted(a):
            found = first_difference(a[key], b[key], f"{where}/{key}")
            if found:
                return found
        return None
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
            return f"{where}: shape or dtype differ"
        if torch.equal(a, b):
            return None
        gap = ((a.double() - b.double()).abs().max() if a.is_floating_point()
               else (a != b).sum())
        return f"{where}: max |diff| {float(gap):.3e}"
    return None if a == b else f"{where}: {a!r} != {b!r}"


def matrix_parity(base: Config, root: str, out: dict) -> dict:
    """Phase 17 a: every device cell against ``run_fast`` of its
    cell_config, one cell of each fallback group against ``run``: final
    params (and for device cells the whole state, the generator's
    included) bit for bit, the same ok sequence.  Returns the standalone
    runs' seconds a round by cell."""
    sweep, per_round = out["sweep"], {}
    grid = sweep.host_state(sweep.state)
    picked = {}
    for cell in sweep.fallback_cells:
        picked.setdefault(cell.group, cell)
    for cell in sweep.device_cells + list(picked.values()):
        directory = os.path.join(root, "alone", cell.key)
        cfg = cell_config(base, cell, rounds=MATRIX_ROUNDS, log_path=directory,
                          checkpoint_dir=directory, telemetry=TelemetryConfig(enabled=False))
        sim = Simulator(cfg, device="cuda")
        device_cell = cell.group in ("batched", "mapped")
        with contextlib.redirect_stdout(io.StringIO()):
            if device_cell:
                state, history = sim.run_fast(state=sim.init_state(), chunk_size=MATRIX_CHUNK,
                                              save_checkpoints=False, verbose=False)
            else:
                state, history = sim.run(state=sim.init_state(), save_checkpoints=False,
                                         verbose=False)
        sim.close()
        if device_cell:
            per_round[cell.key] = sum(h["chunk_seconds"] / h["chunk_len"] for h in history)
            mine = dict(grid[cell.key])
            mine.pop("failures")
            diff = first_difference(mine, sim.host_state(dict(
                state, completed_rounds=int(state["completed_rounds"]),
                have_genuine=bool(state["have_genuine"]))))
        else:
            key = "hnet_params" if cell.group == "special" else "global_params"
            diff = first_difference({"p": out["params"][cell.key]}, {"p": state[key]})
        oks = [h["ok"] for h in history], [h["ok"] for h in out["histories"][cell.key]]
        log(f"[matrix] {cell.key} ({cell.group}): the sweep's final "
            f"{'state' if device_cell else 'params'} against its standalone "
            f"{'run_fast' if device_cell else 'run'}: "
            f"{'bit-equal' if diff is None else 'DIFFERENT at ' + diff}; ok {oks[1]}")
        if diff is not None or oks[0] != oks[1]:
            raise AssertionError(f"matrix {cell.key}: {diff}, ok {oks}")
    return per_round


def matrix_k3(base: Config, out: dict) -> dict:
    """Phase 17 b: K3 at the folded shape against its plain version, bit
    for bit (every device cell's rows keyed on its own seed), its time
    beside its bound; the sweep's K3 launches against the fold's steps
    and FLTrust's root.  Returns the K3 record's additions."""
    sweep = out["sweep"]
    C, cells = base.total_clients, len(sweep.device_cells)
    R = C * cells
    specs = [s for s in TransformerModel().mask_specs([(base.batch_size,)], STEP_RATES)]
    seeds = torch.arange(cells, dtype=torch.int64, device="cuda").repeat_interleave(C) * 7919
    keys = tfs.client_keys(seeds + 5, 3, torch.arange(C, device="cuda").repeat(cells))
    before = tfs.fill_masks.launches
    got = tfs.fill_masks(keys, specs)
    torch.cuda.synchronize()
    want = tfs.dropout_masks(keys, specs)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if tfs.fill_masks.launches != before + 1 or not all(torch.equal(g, w)
                                                        for g, w in zip(got, want)):
        raise AssertionError(f"K3 at the folded shape [{R}, ...] differs from dropout_masks")
    ms = device_ms(lambda: tfs.fill_masks(keys, specs), reps=100)
    t_bytes, t_ops = k3_bound_ms(R, specs)
    bound = max(t_bytes, t_ops)
    nb = -(-base.num_data_range[1] // base.batch_size)
    fltrust = sum(len(out["histories"][c.key]) for c in sweep.device_cells
                  if c.defense == "FLTrust")
    expect = sweep.fold_calls * base.epochs * nb + fltrust * base.epochs * ROOT_STEPS
    parts = -(-cells // sweep.cells_per_part)
    log(f"[matrix] K3 at the folded shape: {len(specs)} tensors at {R} rows in one launch, "
        f"bit-equal to dropout_masks; {ms * 1e3:.3f} us/launch against its bound "
        f"{bound * 1e3:.3f} us ({tfs.mask_work(R, specs)['bytes'] / 1e6:.2f} MB at 3.35 "
        f"TB/s; {t_ops * 1e3:.3f} us of int32 ops), {bound / ms:.1%} of the bound "
        f"({card_line()})")
    log(f"[matrix] K3 launches over the device cells: {out['device_launches']}; the fold "
        f"dispatched {sweep.fold_calls} local updates ({parts} part(s) of at most "
        f"{sweep.cells_per_part} cells a broadcast) x {base.epochs * nb} steps + {fltrust} "
        f"FLTrust broadcasts x {base.epochs * ROOT_STEPS} root steps = {expect}; over the "
        f"whole sweep {out['launches']}")
    if out["device_launches"] != expect:
        raise AssertionError(f"matrix K3 launches {out['device_launches']}, expected {expect}")
    return {"max_abs_err": err, "folded_ms": ms, "folded_bound_ms": bound}


def matrix_syncs(out: dict) -> None:
    """Phase 17 b: the host syncs of the device cells' chunks: one read a
    chunk, FLTrust's cells' included (their root seed stays on the card);
    the first chunk that captures the gradient step's graph among them."""
    for chunk in out["chunks"]:
        seed_reads = sum(n for site, n in chunk["sites"].items() if ROOT_SEED_SITE in site)
        log(f"[matrix] a chunk of {chunk['n']} over {chunk['cells']} cells: "
            f"{chunk['syncs']} host syncs, {seed_reads} of them in the draws, at "
            f"{dict(chunk['sites'])}")
        if chunk["syncs"] != 1 or seed_reads:
            raise AssertionError(f"matrix syncs: {chunk['syncs']} in a chunk, "
                                 f"{seed_reads} of them in the draws")


def matrix_resume(base: Config, root: str, full: dict) -> dict:
    """Phase 17 c: the sweep stopped by its hook at the boundary after the
    first fallback cell, then resumed: the final grid equal to a's, the
    completed fallback cell running zero rounds.  Returns the stopped
    sweep's record (its chunk is a's without the cost model's count)."""
    directory = os.path.join(root, "resume")
    cfg = matrix_base(directory, telemetry=TelemetryConfig(costmodel=False))
    consults = []

    def stop(done):
        return "drain" if len(consults) >= 3 else None

    real = MatrixRun._consult_stop

    def counted(self, hook, completed):
        consults.append(completed)
        return real(self, hook, completed)

    with unittest.mock.patch.object(MatrixRun, "_consult_stop", counted):
        first = matrix_sweep(cfg, stop=stop)
    done = [k for k, h in first["histories"].items()
            if k in {c.key for c in first["sweep"].fallback_cells}]
    resumed = matrix_sweep(cfg.replace(resume=True))
    zero = {k: len(resumed["histories"][k]) for k in done}
    diff = first_difference(matrix_grid_state(full), matrix_grid_state(resumed))
    log(f"[matrix] stopped by the hook ({first['sweep'].stop_reason}, interrupted "
        f"{first['sweep'].interrupted}) after the fallback cells {done}; resumed: device "
        f"chunks {[c['n'] for c in resumed['chunks']]}, the completed fallback cells' rounds "
        f"{zero}; the final grid against a's: "
        f"{'byte-equal' if diff is None else 'DIFFERENT at ' + diff}")
    if (not first["sweep"].interrupted or not done or set(zero.values()) != {0}
            or resumed["chunks"] or diff is not None):
        raise AssertionError(f"matrix resume: done {done}, zero {zero}, diff {diff}")
    return first


def matrix_records(base: Config, root: str) -> None:
    """Phase 17 d: the sweep's ledger records, its matrix and science
    events, ``matrix status`` and ``cost estimate --matrix``."""
    events = read_events(root)
    records = [r for r in LedgerStore(os.path.join(root, "ledger")).load()[0]
               if r.get("source") == "matrix"]
    ids = {r["sweep_id"] for r in records}
    bad = [(e["kind"], validate_event(e)) for e in events
           if e["kind"] in ("matrix", "science") and validate_event(e)]
    actions = Counter(e["action"] for e in events if e["kind"] == "matrix")
    science = [e for e in events if e["kind"] == "science"]
    log(f"[matrix] {len(records)} ledger records sharing {sorted(ids)}; matrix events "
        f"{dict(actions)}, {len(science)} science event (leaderboard "
        f"{[(e['defense'], e['rank']) for e in science[0]['leaderboard']] if science else None}"
        f"); invalid {bad}")
    if (len(records) != len(MATRIX_DEFENSES) * len(MATRIX_ATTACKS) * len(MATRIX_SEEDS)
            or len(ids) != 1 or bad or len(science) != 1):
        raise AssertionError(f"matrix records {len(records)}, ids {ids}, invalid {bad}")
    path = config4_yaml(os.path.join(root, "sweep.yaml"), "xla", root, epochs=MATRIX_EPOCHS,
                        num_data_range=MATRIX_DATA_RANGE)
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh)
    doc["matrix"] = {"attacks": [{"mode": a.mode, "num-clients": a.num_clients,
                                  "attack-round": a.attack_round, "args": list(a.args)}
                                 for a in MATRIX_ATTACKS],
                     "defenses": list(MATRIX_DEFENSES), "seeds": list(MATRIX_SEEDS),
                     "rounds": MATRIX_ROUNDS, "chunk": MATRIX_CHUNK}
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh)
    for argv in (["matrix", "status", "--dir", os.path.join(root, "ledger")],
                 ["cost", "estimate", "--matrix", "--config", path, "--dir",
                  os.path.join(root, "ledger"), "--no-compile"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines()
        log(f"[matrix] {' '.join(argv[:2])}: exit {rc}; {lines[0] if lines else ''}; "
            f"{lines[-1] if lines else ''}")
        if rc != 0:
            raise AssertionError(f"{argv[:2]} exited {rc}")


def fold_costs(base: Config, out: dict) -> None:
    """Phase 17 e: one folded local update of every device cell (a
    broadcast's): its host-issue ms (the call's host time) and its
    device-busy ms (torch.profiler, the union of kernel intervals)."""
    sweep = out["sweep"]
    programs = [sweep.programs[c.key] for c in sweep.device_cells]
    states = [sweep.state[c.key] for c in sweep.device_cells]
    inputs = []
    for prog, state in zip(programs, states):
        gen = torch.Generator(device="cuda")
        gen.set_state(state["rng"].get_state())
        draws = prog.draw(gen)
        inputs.append((draws, prog.halves.prepare(draws, state["broadcasts"] + 1)[1]))
    params = [s["global_params"] for s in states]
    fold = lambda: matrix_program.fold_train(sweep.update, params, inputs,  # noqa: E731
                                             base.total_clients, sweep.cells_per_part)
    replayed = fold()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(local, "counting", lambda: True):
        eager = fold()
    eager_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for (x, _, _), (y, _, _) in zip(eager, replayed)
               for a, b in zip(tree_leaves(x), tree_leaves(y)))
    t0 = time.perf_counter()
    fold()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fold()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    log(f"[matrix] the folded local update of {len(programs)} cells (one broadcast): host "
        f"issue {host_ms:.1f} ms with the gradient's graph replayed ({eager_ms:.1f} ms with "
        f"it issued eagerly; the two bit-equal {same}), device busy "
        f"{busy_us(device) / 1e3:.1f} ms over {len(device)} device rows ({card_line()})")
    if not same:
        raise AssertionError("matrix: the graph's replays differ from the eager step")


def matrix_phase() -> dict:
    """Phase 17: a-e on config 4 (cut).  Returns the K3 launches of a's
    sweep and K3's folded-shape numbers."""
    root = tempfile.mkdtemp(prefix="chip_smoke_matrix_")
    try:
        marks = [time.perf_counter()]
        base = matrix_base(root)
        out = matrix_sweep(base)
        sweep = out["sweep"]
        groups = Counter(c.group for c in sweep.cells)
        log(f"[matrix] sweep of {len(sweep.cells)} cells {dict(groups)} in {out['wall']:.1f} "
            f"s: device chunks {[(c['n'], c['cells'], round(c['seconds'], 3)) for c in out['chunks']]}"
            f" (n, cells, s; the first counts its program), fallback seconds "
            f"{ {k: round(v, 3) for k, v in out['fallback_s'].items()} }; peak "
            f"{out['peak_gib']:.3f} GiB; the batched and mapped groups trained folded (one "
            f"K3 launch a step for {sweep.cells_per_part}-cell parts, the gradient a cell at "
            f"a time: eager in a's counted chunk, one captured graph's replays after)")
        finite = all(bool(torch.isfinite(x).all()) for params in out["params"].values()
                     for x in (tree_leaves(params) if isinstance(params, dict) else [params]))
        for label, prof in sweep._program_profiles.items():
            log(f"[matrix] the cost model's {label}: {prof['flops'] / 1e9:.3f} GFLOP, "
                f"{prof['bytes_accessed'] / 1e9:.3f} GB, {prof['rounds_per_dispatch']} rounds "
                f"x {prof['cells']} cells, peak {prof['memory']['peak'] / 2 ** 30:.3f} GiB; "
                f"counted on the first chunk's dispatch")
        if not finite or len(out["histories"]) != len(sweep.cells) or \
                list(sweep._program_profiles) != [f"matrix_chunk[{MATRIX_CHUNK}]"]:
            raise AssertionError(f"matrix: params finite {finite}, cells run "
                                 f"{len(out['histories'])}")
        standalone = matrix_parity(base, root, out)
        marks.append(time.perf_counter())
        k3 = matrix_k3(base, out)
        matrix_syncs(out)
        marks.append(time.perf_counter())
        stopped = matrix_resume(base, root, out)
        matrix_syncs(stopped)
        marks.append(time.perf_counter())
        matrix_records(base, root)
        marks.append(time.perf_counter())
        chunk = stopped["chunks"][0]
        log(f"[matrix] s/round of the {len(sweep.device_cells)} device cells: "
            f"{chunk['seconds'] / chunk['n']:.4f} (c's chunk: no count, the graph captured in "
            f"it), a's {out['chunks'][0]['seconds'] / out['chunks'][0]['n']:.4f} (its count, "
            f"eager) against the sum of "
            f"their standalone run_fast rounds {sum(standalone.values()) / MATRIX_ROUNDS:.4f} "
            f"({card_line()})")
        fold_costs(base, out)
        marks.append(time.perf_counter())
        log("[phase 17] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcde", marks, marks[1:])))
    finally:
        shutil.rmtree(root)
    return {"launches": out["launches"], **k3}


# phase 18: the audit, the recompile guard and the ledger and science
# command lines.  a: the program audit at config 4 (cut) under each
# backend, and the sweep's program on AUDIT_GRID; b: the guard over each
# executor (GUARD_RUNS: the rounds before the snapshot, the rounds in all,
# run_fast's chunk) and over a sweep of AUDIT_GRID's cells; c: the ledger
# commands over two plain pallas runs, a run with the hotspot window
# HOTSPOT_WINDOW and a copy of the first at half its rate; d: two sweeps of
# SCIENCE_GRID and the sweep views; e:
# `audit --json --device cuda`
AUDIT_GRID = dict(attacks=MATRIX_ATTACKS, defenses=("fedavg", "median"), seeds=(1,),
                  rounds=2, chunk=1)
SCIENCE_GRID = dict(attacks=MATRIX_ATTACKS, defenses=("fedavg", "median"), seeds=(1, 2),
                    rounds=2, chunk=2)
GUARD_RUNS = {"run": (1, 3, None), "run_fast": (3, 6, 3), "pipeline": (1, 3, None)}
# the programs of config 4 that train, and what each trains: broadcasts
AUDIT_TRAINS = {"round_step": 1, "aggregate": 0, "fused_chunk[2]": 2,
                "pipeline_step[eval=True]": 1}


def audit_programs_check(backend: str, root: str) -> dict:
    """18a: every program of config 4 (cut) under ``backend`` audited on
    the card: no sync, no float64, no input written in place, the
    backend's kernel launched epochs (x steps) times a trained broadcast."""
    cfg = cut_config(local_backend=backend, log_path=root, checkpoint_dir=root,
                     telemetry=TelemetryConfig(enabled=False), **SEQUEL_CUT)
    sim = Simulator(cfg, device="cuda")
    reports = program_audit.audit_simulator(sim)
    sim.close()
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    per = cfg.epochs if backend == "pallas" else cfg.epochs * nb
    kernel = BACKEND_KERNEL[backend]
    total = Counter()
    for r in reports:
        d = r.to_dict()
        total.update(r.launches)
        log(f"[audit] {backend} {r.name}: {d['eqns']} ops, syncs {d['syncs']} "
            f"{d['sync_sites']}, float64 outputs {d['f64_outputs']}, inputs written in place "
            f"{sorted(r.writes)}, launches {r.launches}, {r.wall_ms:.1f} ms audited, "
            f"{r.live_ms:.1f} ms as the card runs it")
        expect = {k: 0 for k in KERNELS}
        expect[kernel] = per * AUDIT_TRAINS[r.name]
        if not r.ok or r.launches != expect:
            raise AssertionError(f"audit {backend} {r.name}: problems {r.problems}, "
                                 f"launches {r.launches}, expected {expect}")
    if [r.name for r in reports] != list(AUDIT_TRAINS):
        raise AssertionError(f"audit {backend}: programs {[r.name for r in reports]}")
    return dict(total)


def audit_controls() -> None:
    """18a: the audit sees on the card what it must: a read of a value
    (the dispatch mode's ``_local_scalar_dense`` and
    ``set_sync_debug_mode``'s warning with its site, in the audited run
    and in the run as the card runs it), and K1 writing its inputs p, m
    and v in place from a ctypes launch, which no aten op shows (the
    inputs' bitwise comparison).  Its K1 launch is a control's, not the
    main path's: it is not counted in the kernels line."""
    x = torch.ones(1024, device="cuda")
    read = program_audit.audit_program("control .item()", "sync",
                                       lambda t: (t * 2).sum().item(), (x,), device="cuda")
    groups, batches, _ = kernel_inputs(4, 2, 16, masked_client=0)
    m, v = tfs.zeros_like_groups(groups), tfs.zeros_like_groups(groups)
    k1 = program_audit.audit_program(
        "control K1", "sync", lambda p, m, v, b: tfs.run_epoch(p, m, v, b, 7, 0,
                                                                **step_kwargs(STEP_RATES)),
        (groups, m, v, batches), device="cuda")
    written = {path.split("]")[0] + "]" for path in k1.writes}
    log(f"[audit] control .item(): syncs {read.syncs}; control K1 epoch: {len(k1.writes)} "
        f"input tensors written in place, in arguments {sorted(written)} (p, m, v), seen as "
        f"{sorted({w.split(' @ ')[0] for w in k1.writes.values()})}, launches {k1.launches}")
    card_syncs = [s for s in read.syncs if s.startswith("cuda sync")]
    if (len(read.syncs) < 3 or sum(s.endswith("(graphs replayed)") for s in card_syncs) < 1
            or len(card_syncs) < 2 or written != {"[0]", "[1]", "[2]"}
            or k1.launches["fused_step"] != 1):
        raise AssertionError(f"audit controls: syncs {read.syncs}, K1 writes {k1.writes}")


def audit_sweep_check(root: str) -> dict:
    """18a: the sweep's program on config 4 (cut) under xla, one sweep
    round of AUDIT_GRID's device cells."""
    base = matrix_base(root, telemetry=TelemetryConfig(enabled=False))
    (r,) = program_audit.audit_matrix_program("cuda", base, GridSpec(**AUDIT_GRID))
    d = r.to_dict()
    log(f"[audit] xla {r.name}: {d['eqns']} ops, syncs {d['syncs']} {d['sync_sites']}, "
        f"float64 outputs {d['f64_outputs']}, inputs written in place {sorted(r.writes)}, "
        f"launches {r.launches}, {r.wall_ms:.1f} ms audited op by op, {r.live_ms:.1f} ms "
        f"with its step graph captured and replayed")
    nb = -(-base.num_data_range[1] // base.batch_size)
    if not r.ok or r.launches != {"fused_step": 0, "dropout_mask": base.epochs * nb}:
        raise AssertionError(f"audit {r.name}: problems {r.problems}, launches {r.launches}")
    return r.launches


def guard_check(backend: str, root: str) -> dict:
    """18b: the recompile guard over each executor of config 4 (cut)
    under ``backend``, the cost model on: nothing built, captured or
    loaded after the snapshot."""
    total = Counter()
    for how, (first, rounds, chunk) in GUARD_RUNS.items():
        directory = os.path.join(root, f"guard-{backend}-{how}")
        cfg = cut_config(local_backend=backend, log_path=directory, checkpoint_dir=directory,
                         pipeline_depth=TELEMETRY_DEPTH,
                         telemetry=TelemetryConfig(ledger=False), **SEQUEL_CUT)
        sim = Simulator(cfg, device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            problems = retrace.run_with_guard(sim, how, first, rounds, chunk_size=chunk)
        wall = time.perf_counter() - t0
        built = sorted(retrace.built_programs(sim))
        sim.close()
        launches = launch_counts()
        total.update(launches)
        log(f"[guard] {backend} {how}: snapshot after {first} round(s), {rounds} in all in "
            f"{wall:.2f} s; built {built}; after the snapshot: {problems or 'nothing'}; "
            f"launches {launches}")
        require_kernel(f"guard {backend} {how}", cfg, launches, rounds)
        if problems:
            raise AssertionError(f"guard {backend} {how}: {problems}")
    return dict(total)


def guard_matrix_check(root: str) -> dict:
    """18b: the recompile guard over a sweep of AUDIT_GRID's cells, 3
    rounds in chunks of 1, on config 4 (cut) under xla with the cost model
    off (a counted chunk dispatches op by op and captures no step graph):
    the fold's step graph captured in round 1, nothing after."""
    directory = os.path.join(root, "guard-matrix")
    base = matrix_base(directory, telemetry=TelemetryConfig(costmodel=False, ledger=False))
    sweep = MatrixRun(base, GridSpec(**dict(AUDIT_GRID, rounds=3)), device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        problems = retrace.run_matrix_with_guard(sweep)
    wall = time.perf_counter() - t0
    built = sorted(retrace.built_programs(sweep))
    sweep.close()
    launches = launch_counts()
    nb = -(-base.num_data_range[1] // base.batch_size)
    log(f"[guard] xla matrix: {len(sweep.device_cells)} cells, snapshot after 1 round, 3 in all "
        f"in {wall:.2f} s; built {built}; after the snapshot: {problems or 'nothing'}; "
        f"launches {launches}")
    if (problems or not any(b.startswith("step_graph") for b in built)
            or launches != {"fused_step": 0,
                            "dropout_mask": sweep.fold_calls * base.epochs * nb}):
        raise AssertionError(f"guard matrix: {problems}, built {built}, launches {launches}")
    return launches


def run_command(argv: list) -> tuple[int, str, float]:
    """``python -m attackfl_tpu_torch <argv>`` in this process: exit code,
    stdout and seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def halved_record(ledger: str, record_id: str) -> str:
    """A copy of the ledger's record ``record_id`` at half its rates (the
    steady and with-compile rounds/s, the mean and every rep), appended
    under a new id: a candidate whose rate drop is known.  Returns its id."""
    (record,) = [r for r in LedgerStore(ledger).load()[0] if r["record_id"] == record_id]
    record = json.loads(json.dumps(record))
    for key in ("rounds_per_sec_steady", "rounds_per_sec_incl_compile", "rounds_per_sec_mean"):
        if isinstance(record.get(key), (int, float)):
            record[key] = record[key] / 2
    if isinstance(record.get("per_rep"), list):
        record["per_rep"] = [v / 2 for v in record["per_rep"]]
    record["record_id"] = record["run_id"] = f"{record_id}-halved"
    return LedgerStore(ledger).append(record)


def ledger_commands_check(root: str) -> dict:
    """18c: two plain pallas runs and one with the hotspot window over
    rounds 2-3, into one ledger, and a copy of the first at half its rate;
    `ledger list|show|compare|regress`.  Each `regress` verdict must agree
    with its two records' own rates: exit 1 naming rounds_per_sec exactly
    when the candidate's rate falls more than the verdict's threshold below
    the baseline's, and the halved copy must be flagged.  Whether the
    window costs a run more than the threshold is the card's and the host's
    to say (it did, and it did not, on the H100), so it is logged, not
    gated."""
    ledger = os.path.join(root, "ledger")
    total, ids = Counter(), []
    for label, window in (("plain 1", ""), ("plain 2", ""), ("window", HOTSPOT_WINDOW)):
        directory = os.path.join(root, label.replace(" ", ""))
        cfg = cut_config(local_backend="pallas", log_path=directory, checkpoint_dir=directory,
                         telemetry=TelemetryConfig(hotspots=window, ledger_dir=ledger))
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            run_config(cfg, f"ledger {label}")
        total.update(launch_counts())
        ids.append(LedgerStore(ledger).load()[0][-1]["record_id"])
    first, second, windowed = ids
    halved = halved_record(ledger, first)
    out = {}
    pairs = {"regress": (first, second), "regress window": (first, windowed),
             "regress halved": (first, halved)}
    for name, argv in (("list", ["list", "--json"]), ("show", ["show", second]),
                       ("compare", ["compare", first, second, "--json"]),
                       *((name, ["regress", cand, "--against", base, "--json"])
                         for name, (base, cand) in pairs.items())):
        rc, text, seconds = run_command(["ledger", *argv, "--dir", ledger])
        out[name] = (rc, text)
        log(f"[ledger] {name}: exit {rc} in {seconds:.3f} s")
    perf = json.loads(out["compare"][1])["perf"]
    log("[ledger] compare plain 1 -> plain 2: " + ", ".join(
        f"{k} {v.get('pct', '-')}%" for k, v in perf.items()))
    rates = {r["record_id"]: ledger_compare.effective_rate(r)
             for r in LedgerStore(ledger).load()[0]}
    disagree = []
    for name, (base, cand) in pairs.items():
        verdict = json.loads(out[name][1])
        checks = [v["check"] for v in verdict["violations"]]
        drop = 100.0 * (rates[base] - rates[cand]) / rates[base]
        threshold = verdict["rate_threshold_pct"]
        violations = "; ".join(f"{v['check']} ({v.get('baseline')} -> {v.get('candidate')})"
                               for v in verdict["violations"])
        log(f"[ledger] {name}: exit {out[name][0]}, {verdict['checks']} checks, rate "
            f"{rates[base]:.4f} -> {rates[cand]:.4f} r/s ({drop:.2f}% lower), rate threshold "
            f"{threshold}%, violations {violations or 'none'}")
        if (out[name][0] != (1 if checks else 0)
                or ("rounds_per_sec" in checks) != (drop > threshold)):
            disagree.append(name)
    listed = [e["record_id"] for e in json.loads(out["list"][1])]
    halved_checks = [v["check"] for v in json.loads(out["regress halved"][1])["violations"]]
    if (listed != ids + [halved] or out["show"][0] != 0 or out["compare"][0] != 0
            or disagree or "rounds_per_sec" not in halved_checks):
        raise AssertionError(f"ledger commands: listed {listed}, exits "
                             f"{ {k: v[0] for k, v in out.items()} }, verdicts against the "
                             f"records' rates {disagree}, halved {halved_checks}")
    return dict(total)


def science_commands_check(root: str) -> dict:
    """18d: two sweeps of SCIENCE_GRID (config 4 cut, xla, the cost model
    off) into one ledger; `ledger list --sweep`, `ledger regress
    --sweeps`, `science leaderboard|report|diff --gate`."""
    ledger = os.path.join(root, "ledger")
    total = Counter()
    for sweep_id in ("smoke-a", "smoke-b"):
        base = matrix_base(os.path.join(root, sweep_id),
                           telemetry=TelemetryConfig(costmodel=False, ledger_dir=ledger))
        reset_launches()
        t0 = time.perf_counter()
        sweep = MatrixRun(base, GridSpec(**SCIENCE_GRID), sweep_id=sweep_id, device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            sweep.run(save_checkpoints=False)
        sweep.close()
        total.update(launch_counts())
        log(f"[science] sweep {sweep_id}: {len(sweep.cells)} cells in "
            f"{time.perf_counter() - t0:.1f} s, launches {launch_counts()}")
    report = os.path.join(root, "SCOREBOARD.json")
    rcs = {}
    for argv in (["ledger", "list", "--sweep", "smoke-a"],
                 ["ledger", "regress", "--sweeps", "smoke-a", "smoke-b"],
                 ["science", "leaderboard"], ["science", "report", "--out", report],
                 ["science", "diff", "smoke-a", "smoke-b", "--gate"]):
        rc, text, seconds = run_command([*argv, "--dir", ledger])
        rcs[" ".join(argv[:2])] = rc
        log(f"[science] {' '.join(argv)}: exit {rc} in {seconds:.3f} s")
        for line in text.splitlines()[-4:]:
            log(f"[science]   {line}")
    with open(report) as fh:
        board = json.load(fh)
    if list(rcs.values()) != [0, 0, 0, 0, 0] or board["defenses"] != 2:
        raise AssertionError(f"science commands: exits {rcs}, scoreboard {board['defenses']}")
    return dict(total)


def audit_command_check() -> None:
    """18e: `audit --json --device cuda --skip-grad` on the tree (phase
    19e runs it with the grad audit)."""
    rc, text, seconds = run_command(["audit", "--json", "--device", "cuda", "--skip-grad"])
    report = json.loads(text)
    log(f"[audit] audit --json --device cuda --skip-grad: exit {rc} in {seconds:.1f} s, ok "
        f"{report['ok']}, "
        f"{len(report['findings'])} findings, programs "
        + ", ".join(f"{p['name']} {p['syncs']} syncs {p['wall_ms']:.1f} ms"
                    for p in report["programs"]))
    if rc != 0 or not report["ok"]:
        raise AssertionError(f"audit: exit {rc}, findings {report['findings'][:3]}")


def audit_phase() -> dict:
    """Phase 18: a-e.  Returns the kernels' launches in a's programs and
    b-d's runs (not a's controls)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_audit_")
    total = Counter()
    try:
        marks = [time.perf_counter()]
        audit_controls()
        for backend in ("pallas", "xla"):
            total.update(audit_programs_check(backend, root))
        total.update(audit_sweep_check(root))
        marks.append(time.perf_counter())
        for backend in ("pallas", "xla"):
            total.update(guard_check(backend, root))
        total.update(guard_matrix_check(root))
        marks.append(time.perf_counter())
        total.update(ledger_commands_check(root))
        marks.append(time.perf_counter())
        total.update(science_commands_check(root))
        marks.append(time.perf_counter())
        audit_command_check()
        marks.append(time.perf_counter())
        log("[phase 18] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcde", marks, marks[1:])) + f" ({card_line()})")
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 19: the transform-safety auditor (ROADMAP item 16e).  a: the grad
# programs of audit_config() on the card; b: config 4 (cut) under xla from
# the attacking state, the damage objectives' gradients on the card and on
# the CPU; c: the out-of-place Adam against the in-place step; d:
# FLTrust's chunk syncs and its device root seed; e: `audit --json --device
# cuda` with the grad audit
GRAD_TOL = 1e-4            # 19b: card against CPU, of max |g| (finite entries)
GRAD_PERTURB_STD = 1e-2
GRAD_REPORT = os.path.join(REPO, "tests", "data", "grad_audit_report.json")


def steps_of(cfg: Config) -> int:
    """K3 launches of one broadcast's local training under xla."""
    return cfg.epochs * -(-cfg.num_data_range[1] // cfg.batch_size)


def root_steps_of(cfg: Config) -> int:
    """K3 launches of one FLTrust root update."""
    return cfg.epochs * -(-min(tround.ROOT_SIZE, cfg.test_size) // tround.ROOT_BATCH)


def grad_programs_check() -> None:
    """19a: grad_audit.audit_grad_programs() on the card."""
    from attackfl_tpu_torch.analysis import grad_audit
    from attackfl_tpu_torch.config import audit_config

    reports = grad_audit.audit_grad_programs(device="cuda")
    cfg = audit_config(tempfile.gettempdir())
    names = []
    for r in reports:
        d = r.to_dict()
        names.append(r.name)
        mode, program = r.name.split(":")
        first = program.startswith("grad[")
        broadcasts = 2 if "fused" in program else 1
        root = root_steps_of(cfg) if mode == "FLTrust" else 0
        expect = {"fused_step": 0, "dropout_mask": broadcasts * (steps_of(cfg) + root)}
        log(f"[grad] {r.name} [{r.executor}]: {d['eqns']} ops, syncs {d['syncs']} "
            f"{d['sync_sites']}, float64 outputs {d['f64_outputs']}, inputs written in place "
            f"{sorted(r.writes)}, gradient tree {d['aliased_leaves']}/{d['expected_aliases']} "
            f"leaves, K3 launches {r.launches.get('dropout_mask', 0)}, "
            + (f"{r.wall_ms:.1f} ms audited, {r.live_ms:.1f} ms as the card runs it, peak "
               f"{r.peak_gib:.3f} GiB" if first else f"{r.wall_ms:.1f} ms traced on fake tensors")
            + f" ({card_line()})")
        if not r.ok or (first and (r.launches != expect or d["aliased_leaves"] == 0
                                   or d["aliased_leaves"] != d["expected_aliases"])):
            raise AssertionError(f"grad {r.name}: problems {r.problems}, launches "
                                 f"{r.launches}, expected {expect}")
    want = [f"{m}:{g}" for m in grad_audit.GRAD_MODES
            for g in ("grad[sync_damage]", "grad2[sync_damage]", "grad[fused_damage[2]]")]
    if names != want:
        raise AssertionError(f"grad programs {names}")


def to_cpu(obj):
    """Tensors of nested lists, tuples, dicts and RoundDraws on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_cpu(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def seeded_like(tree: dict, seed: int) -> dict:
    """A perturbation shaped like ``tree``: N(0, GRAD_PERTURB_STD) from a
    numpy generator, on ``tree``'s device."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.from_numpy((GRAD_PERTURB_STD * rng.standard_normal(
        tuple(x.shape))).astype(np.float32)).to(x.device), tree)


def grad_stats(g: dict) -> tuple[int, float]:
    """Non-finite entries of a gradient and its largest finite magnitude."""
    bad = sum(int((~torch.isfinite(x)).sum()) for x in tree_leaves(g))
    top = max(float(torch.where(torch.isfinite(x), x, 0.0).abs().max()) for x in tree_leaves(g))
    return bad, top


def grad_card_and_cpu(root: str) -> dict:
    """19b: the gradients of config 4's damage objectives on the card and on
    the CPU from the same inputs and draws.  Returns the card's launches
    under the gradient (not those of the no_grad runs, the reference)."""
    from attackfl_tpu_torch.analysis.grad_audit import first_order, value_and_grad

    cfg = cut_config(local_backend="xla", log_path=root, checkpoint_dir=root,
                     telemetry=TelemetryConfig(enabled=False))
    card, cpu = Simulator(cfg, device="cuda"), Simulator(cfg, device="cpu")
    state = dict(card.init_state(), have_genuine=True,
                 broadcasts=cfg.attacks[0].attack_round - 1)
    host = dict(to_cpu(state), rng=torch.Generator().manual_seed(cfg.random_seed))
    entries, cpu_entries = card.damage_objective(state), cpu.damage_objective(host)
    drawn, draw = [], card._drawer
    card._drawer = lambda gen, leak_pool=None: drawn.append(draw(gen, leak_pool)) or drawn[-1]
    total = Counter()
    for seed, (entry, cpu_entry) in enumerate(zip(entries, cpu_entries)):
        name, obj = entry["name"], entry["objective"]
        args = (seeded_like(entry["args"][0], seed),) + tuple(entry["args"][1:])
        del drawn[:]
        reset_launches()
        with torch.no_grad():
            plain = obj(*args)
        torch.cuda.synchronize()
        launches_plain = launch_counts()
        draws = list(drawn)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value, g = value_and_grad(obj)(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = launch_counts()
        total.update(launches)
        bad, top = grad_stats(g)
        expect = (2 if "fused" in name else 1) * steps_of(cfg)
        same = bool(torch.equal(plain.view(torch.int32), value.view(torch.int32)))
        # the CPU: the card's draws, the same perturbation
        cpu_args = to_cpu(args)
        if "fused" in name:
            # the CPU body draws the card's rounds; its generator is unused
            queue = iter(to_cpu(draws))
            cpu._drawer = lambda gen, leak_pool=None: next(queue)
            cpu_args = (cpu_args[0], dict(cpu_args[1], rng=torch.Generator()))
        t1 = time.perf_counter()
        g_cpu = first_order(cpu_entry["objective"])(*cpu_args)
        cpu_s = time.perf_counter() - t1
        bad_cpu = sum(int((~torch.isfinite(x)).sum()) for x in tree_leaves(g_cpu))
        masks_equal = all(torch.equal(~torch.isfinite(a.cpu()), ~torch.isfinite(b))
                          for a, b in zip(tree_leaves(g), tree_leaves(g_cpu)))
        err = max(float(torch.where(torch.isfinite(b), a.cpu() - b, 0.0).abs().max())
                  for a, b in zip(tree_leaves(g), tree_leaves(g_cpu)))
        log(f"[grad] config 4 (cut) {name} from the attacking state: value {float(value):.6f} "
            f"(no_grad {float(plain):.6f}, {'bit-equal' if same else 'DIFFERENT'}), "
            f"{ms:.1f} ms for the value and gradient, peak {peak:.3f} GiB, K3 "
            f"{launches['dropout_mask']} launches (expected {expect}), non-finite "
            f"{bad} of {sum(x.numel() for x in tree_leaves(g))} entries, max |g| {top:.6e}; "
            f"on the CPU in {cpu_s:.1f} s: non-finite {bad_cpu}, masks "
            f"{'equal' if masks_equal else 'DIFFERENT'}, max |card - cpu| {err:.3e} "
            f"({err / top if top else float('nan'):.2e} of max |g|) ({card_line()})")
        if (not same or launches != {"fused_step": 0, "dropout_mask": expect}
                or launches_plain != launches or not masks_equal or not top > 0
                or err > GRAD_TOL * top):
            raise AssertionError(f"grad {name}: bits {same}, launches {launches}, masks "
                                 f"{masks_equal}, err {err} of {top}")
    card.close()
    cpu.close()
    return dict(total)


def adam_in_place(p, m, v, g, t: int, lr: float) -> None:
    """19c's plain version: optax ``adam`` then ``apply_updates`` written
    in place."""
    m.mul_(local.B1).add_(g, alpha=1.0 - local.B1)
    v.mul_(local.B2).addcmul_(g, g, value=1.0 - local.B2)
    bc1 = float(np.float32(1.0 - local.B1 ** t))
    bc2 = float(np.float32(1.0 - local.B2 ** t))
    p.add_((m / bc1) / (torch.sqrt(v / bc2) + local.EPS), alpha=-lr)


def adam_step_check(root: str) -> dict:
    """19c: ``local.adam_step``, the local update's out-of-place Adam,
    against the same step written in place (:func:`adam_in_place`), bit
    for bit on the card: p, m and v over six steps of config 4's 100 rows
    (gradients of falling scale, some entries 0, as the inert attention
    leaves' are), then config 4 (cut) through ``run`` for 3 rounds against
    the same run with the in-place step patched in.  Returns the launches
    of the run through ``adam_step`` (not the reference's)."""
    cfg = cut_config(local_backend="xla", log_path=root, checkpoint_dir=root,
                     telemetry=TelemetryConfig(enabled=False))
    sim = Simulator(cfg, device="cuda")
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(sim.init_state()["global_params"])])
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = flat.expand(cfg.total_clients, -1).contiguous()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    opt = {"p": p.clone(), "m": m.clone(), "v": v.clone()}
    same = []
    for t in range(1, 7):
        g = torch.randn(p.shape, generator=gen, device="cuda") * 10.0 ** -t
        g[:, : p.shape[1] // 2 : 2] = 0.0
        adam_in_place(p, m, v, g, t, cfg.lr)
        local.adam_step(opt, g, t, cfg.lr)
        same.append(all(torch.equal(a.view(torch.int32), opt[k].view(torch.int32))
                        for k, a in (("p", p), ("m", m), ("v", v))))
    del p, m, v, opt, g
    runs, launches = [], {}
    for reference in (False, True):
        patched = (unittest.mock.patch.object(
            local, "adam_step", lambda st, g, t, lr: adam_in_place(st["p"], st["m"], st["v"],
                                                                  g, t, lr))
            if reference else contextlib.nullcontext())
        state = sim.init_state()
        reset_launches()
        t0 = time.perf_counter()
        with patched:
            state, history = sim.run(state=state, save_checkpoints=False, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not reference:
            launches = launch_counts()
            require_kernel("adam_step run", cfg, launches, len(history))
        runs.append((state, history, seconds))
    sim.close()
    (a, ha, sa), (b, hb, sb) = runs
    equal = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["global_params"]) + tree_leaves(a["prev_genuine"]),
        tree_leaves(b["global_params"]) + tree_leaves(b["prev_genuine"])))
    metrics = [(h["ok"], h["roc_auc"], h["train_loss"]) for h in ha] == [
        (h["ok"], h["roc_auc"], h["train_loss"]) for h in hb]
    log(f"[grad] local.adam_step against the in-place step at config 4's {tuple(flat.shape)} "
        f"x {cfg.total_clients} rows, lr {cfg.lr}: p, m, v bit-equal at steps 1-6 {same}; "
        f"config 4 (cut) xla run of {len(ha)} rounds through adam_step in {sa:.2f} s (launches "
        f"{launches}, AUC {[round(h['roc_auc'], 4) for h in ha]}) against the in-place step "
        f"patched in ({sb:.2f} s): params and leak pool {'bit-equal' if equal else 'DIFFERENT'}, "
        f"metrics {'equal' if metrics else 'DIFFERENT'}")
    if not (all(same) and equal and metrics):
        raise AssertionError(f"adam_step differs from the in-place step: steps {same}, run "
                             f"{equal}, metrics {metrics}")
    return launches


def fltrust_seed_check(root: str) -> dict:
    """19d: FLTrust on config 4 (cut): a run_fast chunk of 3 makes one host
    sync (its read); the root update with the drawn device seed equals the
    same update given int(seed).  Returns the chunk's launches and the
    device-seed update's (not the int(seed) update's, the reference)."""
    cfg = cut_config(mode="FLTrust", log_path=root, checkpoint_dir=root,
                     telemetry=TelemetryConfig(enabled=False))
    sim = Simulator(cfg, device="cuda")
    total = Counter()
    fresh = sim.init_state()
    reset_launches()
    (_, history), syncs, sites = count_syncs(lambda: sim.run_fast(
        num_rounds=FUSED_CHUNK, state=fresh, chunk_size=FUSED_CHUNK,
        save_checkpoints=False, verbose=False))
    chunk = launch_counts()
    total.update(chunk)
    expect = {"fused_step": FUSED_CHUNK * cfg.epochs,
              "dropout_mask": FUSED_CHUNK * root_steps_of(cfg)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    draws = sim.draw_round(gen)
    update = local.build_root_update(
        sim.model, cfg.data_name, {k: v[:tround.ROOT_SIZE] for k, v in sim.test_data.items()},
        epochs=cfg.epochs, batch_size=tround.ROOT_BATCH, lr=cfg.lr,
        clip_grad_norm=cfg.clip_grad_norm)
    params = sim.init_state()["global_params"]
    reset_launches()
    on_device = update(params, draws.root_perms, draws.root_seed)
    total.update(launch_counts())
    seed = int(draws.root_seed)
    as_int = update(params, draws.root_perms, seed)   # the reference: its launches not counted
    sim.close()
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(on_device), tree_leaves(as_int)))
    log(f"[grad] FLTrust run_fast chunk of {FUSED_CHUNK}: {len(history)} rounds ok "
        f"{[h['ok'] for h in history]}, {syncs} host syncs at {dict(sites)}, launches {chunk} "
        f"(expected {expect}); the root update with the device seed "
        f"({tuple(draws.root_seed.shape)} {draws.root_seed.dtype} on "
        f"{draws.root_seed.device}) against int(seed) {seed}: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if (syncs != SYNCS_PER_CHUNK or len(history) != FUSED_CHUNK
            or not all(h["ok"] for h in history) or chunk != expect or not same):
        raise AssertionError(f"FLTrust chunk: {syncs} syncs at {dict(sites)}, launches {chunk}, "
                             f"root update equal {same}")
    return dict(total)


def grad_command_check() -> None:
    """19e: `audit --json --device cuda` with the grad audit on."""
    rc, text, seconds = run_command(["audit", "--json", "--device", "cuda"])
    report = json.loads(text)
    with open(GRAD_REPORT) as fh:
        golden = {d["name"]: d["verdict"] for d in json.load(fh)["dataflow"]}
    verdicts = {d["name"]: d["verdict"] for d in report["dataflow"]}
    programs = report["grad_programs"]
    skipped = [p["name"] for p in programs if p["skipped"]]
    log(f"[grad] audit --json --device cuda: exit {rc} in {seconds:.1f} s, ok {report['ok']}, "
        f"{len(report['findings'])} findings, {len(programs)} grad programs ("
        + ", ".join(f"{p['name']} {p['syncs']} syncs {p['wall_ms']:.1f} ms"
                    for p in programs if not p["skipped"])
        + f"; skipped {skipped}); dataflow " + ", ".join(
            f"{k.removeprefix('defense:')} {v}" for k, v in sorted(verdicts.items()))
        + f" ({'as' if verdicts == golden else 'NOT as'} the JAX package's table)")
    if rc != 0 or not report["ok"] or verdicts != golden or len(programs) != 12:
        raise AssertionError(f"audit --grad: exit {rc}, findings {report['findings'][:3]}, "
                             f"verdicts {verdicts}")


def grad_phase() -> dict:
    """Phase 19: a-e.  Returns the kernels' launches in b's gradient runs,
    c's run through adam_step and d's runs (not their references')."""
    root = tempfile.mkdtemp(prefix="chip_smoke_grad_")
    total = Counter()
    try:
        marks = [time.perf_counter()]
        grad_programs_check()
        marks.append(time.perf_counter())
        total.update(grad_card_and_cpu(root))
        marks.append(time.perf_counter())
        total.update(adam_step_check(root))
        marks.append(time.perf_counter())
        total.update(fltrust_seed_check(root))
        marks.append(time.perf_counter())
        grad_command_check()
        marks.append(time.perf_counter())
        log("[phase 19] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcde", marks, marks[1:])) + f" ({card_line()})")
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 20: the run service and its scheduler (ROADMAP items 18 and 20).
# a0: J1's and J2's configs as a pair on a RunService with two slots, no
# faults, against their standalone runs' seconds.  a: the same spool (its
# ledger now prices J1's and J2's configs by their peers) on a service
# with two slots, the scheduler on, SERVICE_PLAN (the 2nd status publish
# torn, 3 duplicates flooded at the 3rd submission, J4's, against a depth
# of 3 live jobs, every price x4, one running job force-preempted at the
# 2nd dispatch tick) and the anti-thrash runtime lowered from 2 s.  a2: a
# second service, one slot, worker_death after round 1.  b, in a thread
# beside a and a2: `serve` as a process, three `job submit`s, kill -9, a
# torn entry, a restart, SIGTERM.
SERVICE_PLAN = ("queue_torn@2;submit_flood@3:count=3;estimate_skew@1:count=4;"
                "preempt_storm@2:count=1")
SERVICE_MIN_RUNTIME, SERVICE_DEPTH = 0.5, 3
# J1 and J4 (config 4 under pallas): rounds enough that J1 is still
# running when J4 arrives and J1 or J4 when J3 captures its step graph (at
# 40 rounds both had ended); J2 under xla; J5, J6's successor and b's 2nd
# and 3rd jobs under pallas
LONG_ROUNDS, XLA_ROUNDS, SHORT_ROUNDS = 60, 3, 3
# b's first job: rounds enough to be mid-run when its first checkpoint
# lands and the daemon is killed
MID_ROUNDS = 10
# J3: LIE and none x fedavg and median x seed 1, 2 rounds, chunks of 1:
# the cost model counts the first chunk's dispatch op by op, and the
# second captures the fold's step graph
SERVICE_GRID = {"attacks": [{"mode": "LIE", "num-clients": ATTACKERS, "attack-round": 2,
                             "args": [0.74]},
                            {"mode": "none", "num-clients": ATTACKERS, "attack-round": 2}],
                "defenses": ["fedavg", "median"], "seeds": [1], "rounds": 2, "chunk": 1}
SERVICE_TIMEOUT = 300.0


def config4_raw(backend: str, rounds: int) -> dict:
    """Config 4 (cut) under ``backend`` for ``rounds`` rounds as a job
    spec's config mapping (the YAML schema)."""
    cfg = cut_config(local_backend=backend, num_round=rounds)
    raw = config_raw(cfg)
    from attackfl_tpu_torch.config import config_from_dict

    if config_fingerprint(config_from_dict(raw)) != config_fingerprint(cfg):
        raise AssertionError(f"the {backend} job config is not config 4 (cut)")
    return raw


def wait_until(predicate, what: str, timeout: float = SERVICE_TIMEOUT, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"phase 20: timed out waiting for {what}")


def terminal(service, job_id: str):
    job = service.queue.get(job_id)
    return job if job is not None and job.state in ("done", "failed", "cancelled") else None


def settle_slots(service, label: str) -> None:
    """Wait, its jobs ended, until the scheduler's next tick has released
    their slots.  A drain stops the ticks, so a job that ended after the
    last one keeps its acquire unreleased in the stream, and the fleet
    ledger stretches that open span to the stream's last stop, over a
    later session of the same spool (a fault of the reference, replicated:
    ROADMAP.md §3).  a's spool holds a0's session and a's, so each session
    ends with its books settled."""
    t0 = time.perf_counter()
    pending = len(service.scheduler.snapshot()["jobs"])
    wait_until(lambda: not service.scheduler.snapshot()["jobs"], f"{label}'s slot releases",
               interval=0.01)
    log(f"[service] {label}: {pending} ended job(s) still held a slot when the jobs were "
        f"seen ended; released by the scheduler's tick in {time.perf_counter() - t0:.3f} s, "
        f"before the drain")


def state_gap(a: dict, b: dict) -> str | None:
    """Where two host states differ (None: bit for bit the same)."""
    return first_difference(to_cpu(a), to_cpu(b))


def final_state(directory: str, name: str = "TransformerModel.pth") -> dict:
    return torch.load(os.path.join(directory, name), weights_only=True, map_location="cpu")


def standalone(raw: dict, root: str, label: str) -> tuple[dict, float]:
    """The job's config run alone in this process (no service), saving as a
    job does: the final checkpointed state and the seconds, construction
    included.  A reference: its launches are not counted."""
    from attackfl_tpu_torch.config import config_from_dict

    directory = os.path.join(root, "alone", label)
    cfg = config_from_dict(raw).replace(log_path=directory, checkpoint_dir=directory,
                                        telemetry=TelemetryConfig(enabled=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = Simulator(cfg, device="cuda")
    _, history = sim.run(verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sim.close()
    if not all(h["ok"] for h in history):
        raise AssertionError(f"standalone {label}: a round failed")
    return final_state(directory), seconds


def matrix_standalone(raw: dict, root: str) -> dict:
    """Each cell of J3's grid through ``run_fast`` of its cell_config on the
    card (threefry, as the worker forces it): its host state."""
    from attackfl_tpu_torch.config import config_from_dict
    from attackfl_tpu_torch.matrix.grid import expand_cells, grid_from_dict

    grid = grid_from_dict(SERVICE_GRID)
    base = config_from_dict(raw).replace(prng_impl="threefry2x32")
    out = {}
    for cell in expand_cells(grid):
        directory = os.path.join(root, "alone", cell.key)
        cfg = cell_config(base, cell, rounds=grid.rounds, log_path=directory,
                          checkpoint_dir=directory, telemetry=TelemetryConfig(enabled=False))
        sim = Simulator(cfg, device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            state, _ = sim.run_fast(state=sim.init_state(), chunk_size=grid.chunk,
                                    save_checkpoints=False, verbose=False)
        out[cell.key] = sim.host_state(dict(state, completed_rounds=int(state["completed_rounds"]),
                                            have_genuine=bool(state["have_genuine"])))
        sim.close()
    return out


def service_events(spool: str) -> list:
    with open(os.path.join(spool, "service.events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def job_report(label: str, service, job_id: str, events: list, note: str = "") -> dict:
    """One job's line: its price and the method against the seconds its
    runs took (the job's run_end events, every event valid), its queue
    wait, preemptions and restarts."""
    job = service.queue.get(job_id)
    status = job.status
    admit = next((e for e in events if e["kind"] == "schedule" and e["action"] == "admit"
                  and e.get("job_id") == job_id), {})
    directory = os.path.join(service.spool, "jobs", job_id)
    ran = (sum(e["seconds"] for e in read_events(directory) if e["kind"] == "run_end")
           if os.path.exists(os.path.join(directory, "events.jsonl")) else 0.0)
    row = {"state": job.state, "price": admit.get("predicted_seconds"),
           "method": admit.get("reason"), "ran": ran,
           "wait": status.get("wait_seconds", 0.0),
           "preemptions": int(status.get("preemptions", 0) or 0),
           "restarts": int(status.get("attempts", 0) or 0)}
    log(f"[service] {label} {job_id} {job.state}: price {row['price']} s ({row['method']}"
        f"{note}) against {ran:.3f} s run (its run_end events), queue wait {row['wait']} s, "
        f"preemptions {row['preemptions']}, restarts {row['restarts']}"
        + (f" (last error: {status.get('error')})" if row["restarts"] else "")
        + f" ({card_line()})")
    return row


def pair_run(root: str, raws: dict, alone_s: dict) -> None:
    """a0: J1's and J2's configs submitted together to two slots with no
    faults: the wall seconds from the submits to both done against the sum
    of the standalone runs'; both bit-equal to their standalone runs."""
    from attackfl_tpu_torch.service.daemon import RunService

    spool = os.path.join(root, "a")
    service = RunService(spool, port=0, max_workers=2, device="cuda")
    service.start()
    try:
        t0 = time.perf_counter()
        ids = {label: service.submit({"config": raws[label], "name": f"pair-{label}"})
               for label in ("long", "xla")}
        for job_id in ids.values():
            wait_until(lambda j=job_id: terminal(service, j), f"pair job {job_id}")
        wall = time.perf_counter() - t0
        settle_slots(service, "a0")
    finally:
        service.drain(timeout=60)
        service.close()
    gaps = {label: state_gap(final_state(os.path.join(spool, "jobs", job_id)),
                             alone_s[label][0]) for label, job_id in ids.items()}
    states = {label: service.queue.get(job_id).state for label, job_id in ids.items()}
    total = alone_s["long"][1] + alone_s["xla"][1]
    log(f"[service] a0: J1's config (pallas, {LONG_ROUNDS} rounds) and J2's (xla, {XLA_ROUNDS} "
        f"rounds) as a pair at max_workers 2: {wall:.3f} s from the submits to both done "
        f"against {alone_s['long'][1]:.3f} + {alone_s['xla'][1]:.3f} = {total:.3f} s run "
        f"alone one after the other (construction included in both), ratio "
        f"{wall / total:.3f}; states {states}; bits {gaps} ({card_line()})")
    if set(states.values()) != {"done"} or any(gaps.values()):
        raise AssertionError(f"pair: states {states}, gaps {gaps}")


def capture_watch():
    """Record each StepGraph capture: its seconds, the thread and the K1
    launches other threads made meanwhile."""
    captures = []
    real_init = local.StepGraph.__init__

    def init(self, *a, **k):
        import threading

        k1 = tfs.run_epoch.launches
        t0 = time.perf_counter()
        real_init(self, *a, **k)
        torch.cuda.synchronize()
        captures.append({"seconds": time.perf_counter() - t0,
                         "thread": threading.current_thread().name,
                         "k1_meanwhile": tfs.run_epoch.launches - k1,
                         "threads": sorted(t.name for t in threading.enumerate()
                                           if t.name.startswith("attackfl-worker-"))})

    return captures, unittest.mock.patch.object(local.StepGraph, "__init__", init)


def scheduling_run(root: str, raws: dict, refs: dict, cells: dict) -> dict:
    """a: J1-J4 on one service, two slots.  Returns its K1 and K3
    launches and the launches its jobs must make."""
    from attackfl_tpu_torch.service.daemon import RunService

    spool = os.path.join(root, "a")
    service = RunService(spool, port=0, max_workers=2, queue_depth=SERVICE_DEPTH,
                         device="cuda", sched_min_runtime=SERVICE_MIN_RUNTIME,
                         fault_plan=parse_fault_plan(SERVICE_PLAN))
    captures, patched = capture_watch()
    reset_launches()
    t0 = time.perf_counter()
    with patched:
        # J1 and J2 spooled before the daemon starts: J2's status publish,
        # the 2nd, is torn and the start's replay requeues it; both start,
        # and the storm at the 2nd tick preempts J1, the first running
        j1 = service.submit({"config": raws["long"], "name": "J1", "priority": "low"})
        j2 = service.submit({"config": raws["xla"], "name": "J2", "priority": "normal"})
        service.start()
        try:
            wait_until(lambda: service.queue.get(j1).state == "running"
                       and int(service.queue.get(j1).status.get("preemptions") or 0) >= 1,
                       "J1 to resume after the storm")
            # past the anti-thrash runtime, J4 (the 3rd submission, with the
            # flood's 3 duplicates of it) arrives while J1 and J2 hold both
            # slots; then one submit over HTTP
            time.sleep(SERVICE_MIN_RUNTIME + 0.2)
            slots = sorted(j.job_id for j in service.queue.jobs() if j.state == "running")
            j4 = service.submit({"config": raws["long"], "name": "J4", "priority": "high"})
            code, body = http_post(service.port, "/submit", {"config": raws["long"],
                                                            "name": "probe"})
            live = [j.job_id for j in service.queue.jobs() if j.state in ("queued", "running")]
            rejected = service.telemetry.counters.get("jobs_rejected")
            held = {j1: "J1", j2: "J2"}
            log(f"[service] a: J4 submitted while {[held.get(j, j) for j in slots]} held the "
                f"slots (J2 must still run: its 3 xla rounds outlast J1's resume); the flood "
                f"at its submission: live jobs {len(live)}/{SERVICE_DEPTH}, rejected "
                f"{rejected} (3 duplicates and the /submit); /submit answered {code}: "
                f"{json.loads(body).get('error')}")
            if (code != 429 or sorted(live) != sorted([j1, j2, j4]) or rejected != 4
                    or slots != sorted([j1, j2])):
                raise AssertionError(f"a: /submit answered {code}, live jobs {live}, "
                                     f"rejected {rejected}, slots {slots}")
            # J3 once J2 is done: it runs beside J4
            wait_until(lambda: service.queue.get(j2).state == "done", "J2 to end")
            j3 = service.submit({"type": "matrix", "config": raws["xla"], "grid": SERVICE_GRID,
                                 "name": "J3", "priority": "normal", "sweep_id": "service-j3"})
            ids = {"J1": j1, "J2": j2, "J3": j3, "J4": j4}
            for label, job_id in ids.items():
                wait_until(lambda j=job_id: terminal(service, j), f"{label} to end")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            settle_slots(service, "a")
            health = health_code(service.port)
            fleet_live = fleet_live_check(service)
        finally:
            service.drain(timeout=60)
            service.close()
    events = service_events(spool)
    rows = {label: job_report(f"a {label}", service, job_id, events, ", priced x4")
            for label, job_id in ids.items()}
    schedule = [(e["action"], e.get("job_id"), e.get("reason")) for e in events
                if e["kind"] == "schedule" and e.get("job_id") in ids.values()]
    faults = [e["fault"] for e in events if e["kind"] == "fault"]
    replayed = [e.get("job_id") for e in events
                if e["kind"] == "job" and e["action"] == "requeued"
                and e.get("reason") == "status_torn"]
    log(f"[service] a: {wall:.3f} s; schedule events of J1: "
        f"{[(a, r) for a, j, r in schedule if j == j1]}; of J4: "
        f"{[(a, r) for a, j, r in schedule if j == j4]}; faults {faults}; the torn status "
        f"requeued {replayed}; /healthz {health}")
    names = {f"attackfl-worker-{v}": k for k, v in ids.items()}
    for c in captures:
        log(f"[service] a: J3's step graph captured in {c['seconds']:.3f} s in "
            f"{names.get(c['thread'], c['thread'])} beside "
            f"{[names.get(t, t) for t in c['threads'] if t != c['thread']]}, K1 launched "
            f"{c['k1_meanwhile']} times meanwhile from the other thread")
    # bits: J1, J2 and J4 against their standalone runs, J3's cells
    gaps = {label: state_gap(final_state(os.path.join(spool, "jobs", ids[label])),
                             refs[key][0])
            for label, key in (("J1", "long"), ("J2", "xla"), ("J4", "long"))}
    sweep = torch.load(os.path.join(spool, "jobs", j3, matrix_exec.MATRIX_STATE_FILE),
                       weights_only=True, map_location="cpu")
    for key in cells:
        mine = dict(sweep[key])
        mine.pop("failures")
        gaps[f"J3 {key}"] = state_gap(mine, cells[key])
    log(f"[service] a: final states against the standalone runs: "
        + ", ".join(f"{k} {'bit-equal' if v is None else 'DIFFERENT at ' + v}"
                    for k, v in gaps.items()))
    problems = []
    if {r["state"] for r in rows.values()} != {"done"}:
        problems.append({k: r["state"] for k, r in rows.items()})
    if any(gaps.values()):
        problems.append(gaps)
    if ("preempt", j1, "priority") not in schedule or not any(
            a == "resume" and j == j1 for a, j, _ in schedule):
        problems.append("no priority preemption and resume of J1")
    if sorted(faults) != sorted(["queue_torn", "submit_flood", "estimate_skew", "preempt_storm"]):
        problems.append(f"faults {faults}")
    if replayed != [j2] or health != 200:
        problems.append(f"replayed {replayed}, /healthz {health}")
    if not captures or any(len(c["threads"]) < 2 for c in captures):
        problems.append(f"J3's capture ran beside no other job: {captures}")
    if problems:
        raise AssertionError(f"a: {problems}")
    base = cut_config()
    nb = -(-base.num_data_range[1] // base.batch_size)
    grid_rounds = SERVICE_GRID["rounds"]
    expect = {"fused_step": 2 * LONG_ROUNDS * base.epochs,
              "dropout_mask": (XLA_ROUNDS + grid_rounds) * base.epochs * nb}
    return {"launches": launches, "expect": expect, "wall": wall, "ids": ids,
            "fleet_live": fleet_live}


def supervision_run(root: str, raws: dict, refs: dict) -> dict:
    """a2: J5 under worker_death, J6 with no such model, J7 after it."""
    from attackfl_tpu_torch.service.daemon import RunService

    spool = os.path.join(root, "a2")
    service = RunService(spool, port=0, max_workers=1, worker_retries=1, worker_backoff=0.05,
                         worker_backoff_cap=0.1, device="cuda",
                         fault_plan=parse_fault_plan("worker_death@1"))
    reset_launches()
    service.start()
    try:
        bad = json.loads(json.dumps(raws["short"]))
        bad["server"]["model"] = "NoSuchModel"
        bad["tpu"]["local-backend"] = "xla"   # pallas refuses any model but one first
        ids = {"J5": service.submit({"config": raws["short"], "name": "J5"}),
               "J6": service.submit({"config": bad, "name": "J6"}),
               "J7": service.submit({"config": raws["short"], "name": "J7"})}
        for label, job_id in ids.items():
            wait_until(lambda j=job_id: terminal(service, j), f"{label} to end")
        torch.cuda.synchronize()
        launches = launch_counts()
        settle_slots(service, "a2")
        health = health_code(service.port)
    finally:
        service.drain(timeout=60)
        service.close()
    events = service_events(spool)
    rows = {label: job_report(f"a2 {label}", service, job_id, events)
            for label, job_id in ids.items()}
    j6 = service.queue.get(ids["J6"]).status
    job_events = read_events(os.path.join(spool, "jobs", ids["J5"]))
    resumed = [e["round"] for e in job_events if e["kind"] == "resume"]
    gaps = {label: state_gap(final_state(os.path.join(spool, "jobs", ids[label])),
                             refs["short"][0]) for label in ("J5", "J7")}
    log(f"[service] a2: J5 killed by worker_death after round 1, resumed from round "
        f"{resumed}, {rows['J5']['restarts']} restart; J6 {j6['state']} after "
        f"{j6.get('attempts')} attempts: {j6.get('error')}; J7 {rows['J7']['state']}; final "
        f"states against the standalone run: "
        + ", ".join(f"{k} {'bit-equal' if v is None else 'DIFFERENT at ' + v}"
                    for k, v in gaps.items()) + f"; /healthz {health}")
    if (rows["J5"]["state"] != "done" or rows["J5"]["restarts"] != 1 or resumed != [1]
            or j6["state"] != "failed" or j6.get("attempts") != 2
            or "NoSuchModel" not in str(j6.get("error")) or rows["J7"]["state"] != "done"
            or any(gaps.values()) or health != 200):
        raise AssertionError(f"a2: {rows}, J6 {j6}, resumed {resumed}, gaps {gaps}")
    base = cut_config()
    return {"launches": launches, "ids": ids,
            "expect": {"fused_step": 2 * SHORT_ROUNDS * base.epochs, "dropout_mask": 0}}


def http_post(port: int, path: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST")
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def daemon_launches(url: str) -> dict:
    """The daemon's /metrics kernel launch counts."""
    with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    out = {}
    for name in KERNELS:
        m = re.search(rf'attackfl_kernel_launches_total{{kernel="{name}"}} (\d+)', text)
        out[name] = int(m.group(1)) if m else 0
    return out


def job_command(argv: list) -> tuple[int, str]:
    """``python -m attackfl_tpu_torch job <argv>`` as a process of its own
    (the `job` client imports no torch): exit code and stdout.  b runs
    beside a and a2 in a thread, so it cannot redirect this process's
    stdout as ``run_command`` does."""
    done = subprocess.run([sys.executable, "-m", "attackfl_tpu_torch", "job", *argv], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=SERVICE_TIMEOUT + 60)
    return done.returncode, done.stdout


def daemon_run(root: str, raws: dict, refs: dict) -> dict:
    """b: `serve` as a process on the card, three `job submit`s, kill -9
    once the first job's manifest exists, a queued entry torn, a restart;
    then SIGTERM.  Returns the daemons' kernel launches (/metrics)."""
    import yaml

    spool = os.path.join(root, "b")
    paths = {}
    for label in ("mid", "short"):
        paths[label] = os.path.join(root, f"b-{label}.yaml")
        with open(paths[label], "w") as fh:
            yaml.safe_dump(raws[label], fh)
    argv = [sys.executable, "-m", "attackfl_tpu_torch", "serve", "--spool", spool, "--port", "0",
            "--max-workers", "1", "--worker-backoff", "0.05"]
    env = dict(os.environ, PYTHONPATH=REPO)
    logs = open(os.path.join(root, "serve.log"), "w")

    def start():
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=logs, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()

        def up():
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}")
            try:
                with open(os.path.join(spool, "service.json")) as fh:
                    disc = json.load(fh)
            except (OSError, ValueError):
                return None
            return disc["url"] if disc.get("pid") == proc.pid else None

        url = wait_until(up, "serve's discovery file", interval=0.1)
        return proc, url, time.perf_counter() - t0

    t0 = time.perf_counter()
    marks = {}
    proc, url, up_s = start()
    first = None
    launches = Counter()
    try:
        ids = []
        for i, label in enumerate(("mid", "short", "short")):
            rc, out = job_command(["submit", "--spool", spool, "--config", paths[label],
                                   "--name", f"b{i + 1}"])
            if rc != 0:
                raise AssertionError(f"job submit exit {rc}")
            ids.append(out.strip())
        marks["submitted"] = time.perf_counter() - t0
        wait_until(lambda: os.path.exists(os.path.join(spool, "jobs", ids[0], "manifest.json")),
                   "b1's first checkpoint")
        marks["first checkpoint"] = time.perf_counter() - t0
        # a lower bound of the first daemon's launches: K1 may launch again
        # between this read and the kill
        first = daemon_launches(url)
        proc.kill()
        proc.wait(timeout=60)
        marks["killed"] = time.perf_counter() - t0
        status = os.path.join(spool, "queue", f"{ids[1]}.status.json")
        with open(status, "rb") as fh:
            data = fh.read()
        with open(status, "wb") as fh:
            fh.write(data[:len(data) // 2])
        proc, url, up2_s = start()
        marks["restarted"] = time.perf_counter() - t0
        for job_id in ids:
            rc, out = job_command(["wait", job_id, "--spool", spool, "--timeout",
                                   str(int(SERVICE_TIMEOUT)), "--interval", "0.1"])
            if rc != 0:
                raise AssertionError(f"job wait {job_id}: exit {rc}: {out}")
        marks["all done"] = time.perf_counter() - t0
        launches.update(daemon_launches(url))
        rc, listing = job_command(["list", "--spool", spool])
        watch = watch_fleet_command(url)
        proc.terminate()
        exit_code = proc.wait(timeout=120)
        marks["drained"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        logs.close()
    events = service_events(spool)
    requeued = {e["job_id"]: e["reason"] for e in events
                if e["kind"] == "job" and e["action"] == "requeued"}
    gaps = {job_id: state_gap(final_state(os.path.join(spool, "jobs", job_id)),
                              refs[label][0])
            for job_id, label in zip(ids, ("mid", "short", "short"))}
    log(f"[service] b: serve up in {up_s:.1f} s and {up2_s:.1f} s after the kill -9; "
        f"the replay requeued {requeued}; `job list`: {' | '.join(listing.splitlines())}; "
        f"SIGTERM exit {exit_code}; K1/K3 launches of the first daemon by its last /metrics "
        f"before the kill (a lower bound) {first}, of the second {dict(launches)}; seconds "
        f"from the first start: {', '.join(f'{k} {v:.1f}' for k, v in marks.items())}; "
        f"final states against the "
        f"standalone runs: " + ", ".join(f"{k} {'bit-equal' if v is None else 'DIFFERENT at ' + v}"
                                         for k, v in gaps.items()) + f" ({card_line()})")
    if (exit_code != 0 or requeued.get(ids[0]) != "interrupted"
            or requeued.get(ids[1]) != "status_torn" or any(gaps.values())
            or launches["fused_step"] == 0):
        raise AssertionError(f"b: exit {exit_code}, requeued {requeued}, gaps {gaps}, "
                             f"launches {dict(launches)}")
    launches.update(first)
    return {"launches": dict(launches), "ids": ids, "watch": watch}


# phase 20c: the fleet observatory on phase 20's spools (ROADMAP item 21).
# Live: /fleet and the SLO gauges on /metrics of a's service before it
# closes, `watch --fleet --once` against b's second daemon before its
# drain.  Then `fleet report --json`, `fleet trace` and `metrics --merge`
# over a's spool (a0's session and a's), a2's and b's (its killed daemon
# and the restart).  It submits no job and launches neither kernel.
FLEET_SLOTS = {"a": 2, "a2": 1, "b": 1}
SLO_PRIORITIES = {"low", "normal", "high"}


def fleet_live_check(service) -> dict:
    """20c in a, its jobs ended and its service still up: /fleet answers
    the SLO report and the ledger with no error; /metrics carries a p95
    queue wait for each priority class a used and the preemption rate,
    shed rate and starvation margin; the preemption rate is above 0 (J1
    was preempted) and the shed rate is the stream's sheds over its admits
    and sheds: the flood's 429s are depth rejections, which no shed
    horizon priced."""
    t0 = time.perf_counter()
    code, body = http_get(service.port, "/fleet")
    payload = json.loads(body)
    _, text = http_get(service.port, "/metrics")
    gauges = cli._parse_prom(text.decode())
    events = load_events(os.path.join(service.spool, "service.events.jsonl"))
    seconds = time.perf_counter() - t0
    admits = sum(e.get("kind") == "schedule" and e.get("action") == "admit" for e in events)
    sheds = sum(e.get("kind") == "schedule" and e.get("action") == "shed" for e in events)
    rejected = service.telemetry.counters.get("jobs_rejected")
    slo = {k: v for k, v in gauges.items() if k.startswith("attackfl_slo_")}
    p95 = {k.split('priority="', 1)[1].rstrip('"}'): v for k, v in slo.items()
           if k.startswith("attackfl_slo_queue_wait_p95_seconds{")}
    shed_rate = round(sheds / (admits + sheds), 4) if admits + sheds else 0.0
    ledger = payload.get("ledger") or {}
    log(f"[20c] a live: /fleet {code} with {sorted(payload)}, books "
        f"{'closed' if ledger.get('books_close') else 'OPEN'} at "
        f"{ledger.get('identity_error_pct')}% so far; /metrics SLO gauges: "
        + ", ".join(f"{k} {v}" for k, v in sorted(slo.items()))
        + f"; shed rate {gauges.get('attackfl_slo_shed_rate')} against the stream's {sheds} "
        f"sheds over {admits} admits ({shed_rate}), the flood's {rejected} rejections "
        f"answered 429 at the queue's depth, not shed; {seconds:.3f} s ({card_line()})")
    problems = []
    if code != 200 or sorted(payload) != ["ledger", "slo"]:
        problems.append(f"/fleet {code} {payload.get('error') or sorted(payload)}")
    if set(p95) != SLO_PRIORITIES or any(
            name not in gauges for name in ("attackfl_slo_preemption_rate",
                                             "attackfl_slo_shed_rate",
                                             "attackfl_slo_starvation_bound_margin_seconds")):
        problems.append(f"SLO gauges {sorted(slo)}")
    if not gauges.get("attackfl_slo_preemption_rate", 0) > 0:
        problems.append("preemption rate 0")
    if gauges.get("attackfl_slo_shed_rate") != shed_rate or sheds or rejected != 4:
        problems.append(f"shed rate {gauges.get('attackfl_slo_shed_rate')}, sheds {sheds}, "
                        f"admits {admits}, rejected {rejected}")
    if problems:
        raise AssertionError(f"20c a live: {problems}")
    return seconds


def watch_fleet_command(url: str) -> dict:
    """20c in b: ``python -m attackfl_tpu_torch watch --fleet --once`` as a
    process against the restarted daemon: exit 0 and an ``slo:`` part."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "attackfl_tpu_torch", "watch", "--fleet",
                           "--once", url], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    if done.returncode != 0 or "slo:" not in done.stdout:
        raise AssertionError(f"20c b: watch --fleet --once exit {done.returncode}: "
                             f"{done.stdout} {done.stderr}")
    return {"seconds": seconds, "line": done.stdout.strip()}


def run_command_err(argv: list) -> tuple[int, str, str]:
    """``run_command`` with the standard error kept: code, stdout, stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, out, _ = run_command(argv)
    return rc, out, err.getvalue()


def jsonl_count(path: str) -> int:
    with open(path) as fh:
        return sum(1 for line in fh if line.strip())


def job_stream(spool: str, job_id: str) -> list:
    """A job's own events as the fleet trace reads them (a line torn by a
    kill -9 skipped); none when the job wrote no stream."""
    path = os.path.join(spool, "jobs", job_id, "events.jsonl")
    if not os.path.exists(path):
        return []
    return [e for e in load_events(path) if e.get("kind") != "_skipped"]


def fleet_report_check(label: str, spool: str, ids: dict, card: str) -> dict:
    """``fleet report --json`` on one spool: exit 0, the books closed, the
    slots, a row for every dispatched job ending as phase 20 asserts (J6
    failed, the rest completed), J1 preempted, every row priced."""
    rc, out, err = run_command_err(["fleet", "report", spool, "--json"])
    if rc != 0:
        raise AssertionError(f"20c {label}: fleet report exit {rc}: {err}")
    ledger = json.loads(out)["ledger"]
    names = {job_id: name for name, job_id in ids.items()}
    events = load_events(os.path.join(spool, "service.events.jsonl"))
    dispatched = {e["job_id"] for e in events if e.get("kind") == "schedule"
                  and e.get("action") in ("pack", "resume")}
    rows = {row["job_id"]: row for row in ledger["jobs"]}
    log(f"[20c] {label}: wall {ledger['wall_seconds']} s x {ledger['slots']} slot(s), busy "
        f"{ledger['busy_seconds_total']} s + idle {ledger['idle_seconds_total']} s, identity "
        f"error {ledger['identity_error_pct']}% (books "
        f"{'closed' if ledger['books_close'] else 'OPEN'}); tenants' busy shares "
        + ", ".join(f"{t} {b['share_of_busy']}" for t, b in ledger["tenants"].items())
        + "; jobs predicted against billed: "
        + ", ".join(f"{names.get(j, j)} {r['predicted_seconds']} s / {r['busy_seconds']} s "
                    f"(x{r['prediction_error_factor']}, {r['end_action']}, preemptions "
                    f"{r['preemptions']})" for j, r in rows.items()) + f" ({card})")
    problems = []
    if not ledger["books_close"] or ledger["slots"] != FLEET_SLOTS[label]:
        problems.append(f"books {ledger['identity_error_pct']}%, slots {ledger['slots']}")
    if not dispatched or not dispatched <= set(rows):
        problems.append(f"dispatched {sorted(dispatched)}, rows {sorted(rows)}")
    for job_id, row in rows.items():
        want = "failed" if names.get(job_id) == "J6" else "completed"
        if row["end_action"] != want or row["prediction_error_factor"] is None:
            problems.append(f"{names.get(job_id, job_id)}: {row}")
    if "J1" in ids and rows[ids["J1"]]["preemptions"] < 1:
        problems.append(f"J1 not preempted: {rows[ids['J1']]}")
    if problems:
        raise AssertionError(f"20c {label}: {problems}")
    return {"ledger": ledger, "dispatched": dispatched}


def fleet_trace_check(label: str, spool: str, dispatched: set) -> int:
    """``fleet trace`` on one spool: exit 0, a loadable file, one slot
    thread per slot used, and for every dispatched job a queue-wait span,
    a run span and at least as many chunk or round spans as its own
    stream records."""
    out = os.path.join(spool, "fleet.trace.json")
    rc, _, err = run_command_err(["fleet", "trace", spool, "--out", out])
    with open(out) as fh:
        trace = json.load(fh)["traceEvents"]
    events = load_events(os.path.join(spool, "service.events.jsonl"))
    used = {e["slot"] for e in events if e.get("kind") == "slot" and e.get("action") == "acquire"}
    threads = {e["tid"] for e in trace if e["ph"] == "M" and e["pid"] == 1 and "tid" in e}
    problems = [] if rc == 0 else [f"exit {rc}: {err}"]
    if threads != used:
        problems.append(f"slot threads {threads}, slots used {used}")
    for job_id in sorted(dispatched):
        spans = Counter(e["cat"] for e in trace if e["ph"] == "X"
                        and e.get("args", {}).get("job_id") == job_id
                        and (e["cat"] != "wait" or e["name"] == "queue-wait"))
        recorded = sum(e["kind"] in ("chunk", "round") for e in job_stream(spool, job_id))
        if not spans["wait"] or not spans["run"] or spans["chunk"] < recorded:
            problems.append(f"{job_id}: spans {dict(spans)}, chunk or round events {recorded}")
    if problems:
        raise AssertionError(f"20c {label} trace: {problems}")
    return len(trace)


def fleet_merge_check(spool: str, card: str) -> None:
    """``metrics --merge`` on a's spool: exit 0 under ``--json``, each
    source's count that file's own, the merged timestamps not decreasing;
    ``--merge --forensics`` exits 0 on attribution events, else 2 with JAX's
    message."""
    rc, out, err = run_command_err(["metrics", spool, "--merge", "--json"])
    if rc != 0:
        raise AssertionError(f"20c merge: exit {rc}: {err}")
    counts = json.loads(out)["events_per_process"]
    own = {key: jsonl_count(os.path.join(spool, "service.events.jsonl") if key == "service"
                            else os.path.join(spool, "jobs", key, "events.jsonl"))
           for key in counts}
    merged, _ = merge.merge_events(spool)
    stamps = [e.get("ts") for e in merged]
    rising = all(isinstance(t, (int, float)) for t in stamps) and stamps == sorted(stamps)
    frc, fout, ferr = run_command_err(["metrics", spool, "--merge", "--forensics", "--json"])
    verdict = (f"exit 0, defenses {sorted(json.loads(fout).get('by_defense') or {})}" if frc == 0
               else f"exit {frc}: {ferr.strip()}")
    log(f"[20c] a metrics --merge: {len(counts)} sources, {len(merged)} events, counts "
        f"{'equal to' if counts == own else 'DIFFERENT from'} the files' own, timestamps "
        f"{'not decreasing' if rising else 'OUT OF ORDER'}; --merge --forensics {verdict} "
        f"({card})")
    if counts != own or not rising or not (
            frc == 0 or (frc == 2 and "no attribution events found in the merged stream" in ferr)):
        raise AssertionError(f"20c merge: counts {counts} against {own}, rising {rising}, "
                             f"forensics {frc} {ferr}")


def killed_job_bill(spool: str, job_id: str, ledger: dict, card: str) -> None:
    """b's job running at the kill -9: the ledger's bill beside its slot
    events and the run seconds its own stream records across both
    daemons.  The reference keys an open slot span by (slot, job_id), so
    the restart's acquire of the same slot drops the killed daemon's span
    (ROADMAP.md, faults of the reference, replicated): the bill is the
    restarted span alone, and the killed run's time on the slot is idle."""
    service = load_events(os.path.join(spool, "service.events.jsonl"))
    t0 = next(e["ts"] for e in service if e.get("kind") == "service")
    slot = [(e["action"], e["ts"] - t0) for e in service
            if e.get("kind") == "slot" and e.get("job_id") == job_id]
    runs: dict = {}
    for e in job_stream(spool, job_id):
        run = runs.setdefault(e.get("run_id"), {"first": e["ts"], "last": e["ts"], "rounds": 0,
                                                "round_s": 0.0, "run_end": None})
        run["last"] = e["ts"]
        if e["kind"] == "round":
            run["rounds"] += 1
            run["round_s"] += e.get("seconds") or 0.0
        elif e["kind"] == "run_end":
            run["run_end"] = e.get("seconds")
    billed = next(r["busy_seconds"] for r in ledger["jobs"] if r["job_id"] == job_id)
    acquires = [ts for action, ts in slot if action == "acquire"]
    killed = (next(iter(runs.values()))["last"] - t0 - acquires[0]
              if runs and len(acquires) > 1 else 0.0)
    log(f"[20c] b's killed job {job_id}: billed {billed} s; its slot events (s from the "
        f"session's start): " + ", ".join(f"{a} {ts:.3f}" for a, ts in slot)
        + "; its events.jsonl: "
        + "; ".join(f"run {i + 1} {r['rounds']} rounds, {r['round_s']:.3f} s of rounds, "
                    f"{r['first'] - t0:.3f}-{r['last'] - t0:.3f} s, run_end {r['run_end']}"
                    for i, r in enumerate(runs.values()))
        + f"; the killed daemon's span, from its acquire to run 1's last event, "
        f"{killed:.3f} s, is billed to no one (the (slot, job_id) key dropped it); kept, the "
        f"bill would be {billed + killed:.3f} s ({card})")


def fleet_phase(root: str, parts: dict) -> None:
    """20c after the daemons: ``fleet report``, ``fleet trace`` on a's,
    a2's and b's spools, ``metrics --merge`` on a's, b's killed job's bill;
    then 20c's seconds with the live checks'."""
    card = card_line()
    t0 = time.perf_counter()
    ids = {"a": parts["a"]["ids"], "a2": parts["a2"]["ids"],
           "b": {f"b{i + 1}": j for i, j in enumerate(parts["b"]["ids"])}}
    reports, spans = {}, {}
    for label in FLEET_SLOTS:
        spool = os.path.join(root, label)
        reports[label] = fleet_report_check(label, spool, ids[label], card)
        spans[label] = fleet_trace_check(label, spool, reports[label]["dispatched"])
    fleet_merge_check(os.path.join(root, "a"), card)
    killed_job_bill(os.path.join(root, "b"), ids["b"]["b1"], reports["b"]["ledger"], card)
    after = time.perf_counter() - t0
    live = parts["a"]["fleet_live"]
    watch = parts["b"]["watch"]
    log(f"[20c] fleet trace events {spans}; b's `watch --fleet --once` in "
        f"{watch['seconds']:.3f} s: {watch['line']}; 20c took {after:.3f} s after the daemons, "
        f"{live:.3f} s live in a and {watch['seconds']:.3f} s in b's thread, "
        f"{after + live + watch['seconds']:.3f} s in all ({card})")


def service_phase() -> dict:
    """Phase 20: a0, then a and a2 in this thread beside b in another (b
    waits on its `serve` processes most of its time), then 20c over the
    spools they leave.  Returns the
    kernels' launches in a's and a2's jobs and b's daemons (not the
    standalone runs', nor a0's)."""
    import threading

    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        marks = [time.perf_counter()]
        raws = {"long": config4_raw("pallas", LONG_ROUNDS), "xla": config4_raw("xla", XLA_ROUNDS),
                "short": config4_raw("pallas", SHORT_ROUNDS),
                "mid": config4_raw("pallas", MID_ROUNDS)}
        log(f"[service] jobs: config 4 (cut: {DEPTH['cut']}) at full width under pallas for "
            f"{LONG_ROUNDS} rounds (J1, J4), {MID_ROUNDS} (b1) and {SHORT_ROUNDS} (J5, J7, b2, b3), "
            f"under xla "
            f"for {XLA_ROUNDS} rounds (J2), and J3 a 2 x 2 x 1 matrix of J2's config and depth "
            f"over {SERVICE_GRID['rounds']} rounds")
        with contextlib.redirect_stdout(io.StringIO()):
            refs = {label: standalone(raw, root, label) for label, raw in raws.items()}
            cells = matrix_standalone(raws["xla"], root)
        log("[service] standalone runs: " + ", ".join(
            f"{k} {v[1]:.3f} s" for k, v in refs.items()) + f" ({card_line()})")
        marks.append(time.perf_counter())
        pair_run(root, raws, refs)
        marks.append(time.perf_counter())
        b = {}

        def run_b():
            t0 = time.perf_counter()
            try:
                b.update(daemon_run(root, raws, refs))
            except BaseException as e:  # noqa: BLE001 -- raised again in the phase's thread
                b["error"] = e
            b["seconds"] = time.perf_counter() - t0

        side = threading.Thread(target=run_b, name="phase20-b", daemon=True)
        side.start()
        try:
            a = scheduling_run(root, raws, refs, cells)
            marks.append(time.perf_counter())
            a2 = supervision_run(root, raws, refs)
            marks.append(time.perf_counter())
        finally:
            side.join(timeout=3 * SERVICE_TIMEOUT)
        if side.is_alive():
            raise AssertionError("phase 20 b did not end")
        if "error" in b:
            raise b["error"]
        marks.append(time.perf_counter())
        total = Counter(a["launches"])
        total.update(a2["launches"])
        expect = Counter(a["expect"])
        expect.update(a2["expect"])
        log(f"[service] K1 and K3 launches over a and a2: {dict(total)} (a {a['launches']}, a2 "
            f"{a2['launches']}), the jobs' rounds x epochs and rounds x steps {dict(expect)}; "
            f"counted process-wide from every worker thread")
        if total != expect:
            raise AssertionError(f"service launches {dict(total)}, expected {dict(expect)}")
        total.update(b["launches"])
        fleet_phase(root, {"a": a, "a2": a2, "b": b})
        marks.append(time.perf_counter())
        log("[phase 20] " + ", ".join(f"{k} {y - x:.1f} s" for k, x, y in
                                      zip(("references", "a0", "a", "a2", "b's wait after a2",
                                           "20c after the daemons"),
                                          marks, marks[1:]))
            + f" (b {b['seconds']:.1f} s beside a and a2), in all {marks[-1] - marks[0]:.1f} s "
            f"({card_line()})")
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 21: the client mesh in one process (ROADMAP item 14a) on MESH_SHARDS
# shards of cuda:0 (the card is one device; a copy between two shards of it
# is a no-op).  b's and e's global params against the meshless run after
# round 1 within MESH_PARAM_TOL, JAX's bound for sharded against replicated
# (tests/test_sharding.py:51-89); d's psum modes within MESH_AGG_TOL of the
# meshless aggregator (:206-249); c's rows, where cuBLAS parts them, at
# PARAM_TOL on the entries whose first-step gradient is at least GRAD_FLOOR
# (K1's cold-Adam gate); f's sweep: LIE and none x fedavg and median, seed 1
MESH_SHARDS, MESH_PARAM_TOL, MESH_AGG_TOL = 2, 1e-5, 2e-6
MESH_GRID = dict(attacks=MATRIX_ATTACKS, defenses=("fedavg", "median"), seeds=(1,),
                 rounds=MATRIX_ROUNDS, chunk=1)


def mesh_of(shards: int):
    from attackfl_tpu_torch.parallel.mesh import make_client_mesh

    return make_client_mesh(devices=["cuda:0"] * shards)


def same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def mesh_k1_check() -> None:
    """21a: K1 from the warm state at config 4's shapes, dropout on: two
    launches of C/2 clients at bases 0 and C/2 against one launch of C,
    bit for bit; the base's launch against the plain version with the same
    base, at check_fused_step's gates; the second half at base 0 as a
    control (other masks).  None of these launches is the main path's."""
    C, B = CONFIG4["total_clients"], CONFIG4["batch_size"]
    nb = -(-DEPTH["cut"]["num_data_range"][1] // B)
    masked, half = 7, C // 2
    groups, batches, live = kernel_inputs(C, nb, B, masked)
    live = {k: x != 0 for k, x in live.items()}
    for x in live.values():
        x[masked] = False
    m0, v0 = warm_state(live, masked)
    kw = step_kwargs(STEP_RATES)

    def launch(rows: slice, base: int, plain: bool = False):
        state = [{k: x[rows].clone() for k, x in s.items()} for s in (groups, m0, v0)]
        fn = tfs.run_epoch_reference if plain else tfs.run_epoch
        *out, loss = fn(*state, batches[rows].contiguous(), 17, 100, client_base=base, **kw)
        torch.cuda.synchronize()
        return out, loss

    whole, whole_loss = launch(slice(0, C), 0)
    first, first_loss = launch(slice(0, half), 0)
    second, second_loss = launch(slice(half, C), half)
    gaps = [max(float((torch.cat([a[k], b[k]]) - w[k]).abs().max()) for k in tfs.GROUP_ORDER)
            for a, b, w in zip(first, second, whole)]
    loss_gap = float((torch.cat([first_loss, second_loss]) - whole_loss).abs().max())
    (rp, rm, rv), rloss = launch(slice(half, C), half, plain=True)
    p_err, m_err, v_err = (max_abs(k, r) for k, r in zip(second, (rp, rm, rv)))
    m_tol, v_tol = MV_RTOL * max_abs(rm), MV_RTOL * max_abs(rv)
    loss_err = float((second_loss - rloss).abs().max()) / nb
    control, _ = launch(slice(half, C), 0)
    moved = max_abs(control[0], {k: x[half:] for k, x in whole[0].items()})
    log(f"[21a] K1 C={C} nb={nb} B={B}, dropout {STEP_RATES}, warm state: launches of "
        f"{half} clients at bases 0 and {half} side by side against one of {C}: max |delta| "
        f"p {gaps[0]:.3g}, m {gaps[1]:.3g}, v {gaps[2]:.3g}, loss {loss_gap:.3g}; at base "
        f"{half} against its plain version: p {p_err:.3g} (tol {PARAM_TOL}), m {m_err:.3g} "
        f"(tol {m_tol:.3g}), v {v_err:.3g} (tol {v_tol:.3g}), loss/step {loss_err:.3g} (tol "
        f"{LOSS_TOL_PER_STEP}); control, the second half at base 0: p moves {moved:.3g} "
        f"({card_line()})")
    if max(gaps) != 0.0 or loss_gap != 0.0:
        raise AssertionError(f"21a: K1's halves differ from the whole launch by {gaps}, "
                             f"loss {loss_gap}")
    if not (p_err <= PARAM_TOL and m_err <= m_tol and v_err <= v_tol
            and loss_err <= LOSS_TOL_PER_STEP) or moved == 0.0:
        raise AssertionError("21a: K1 with a client base differs from its plain version, "
                             "or the base changes nothing")
    PHASE_ERRORS["fused_step"] = max(PHASE_ERRORS.get("fused_step", 0.0), p_err)


def first_round(sim: Simulator, state: dict):
    """Broadcast 1's draws and round step from ``state``'s generator (a
    copy), as ``run`` takes them."""
    gen = torch.Generator(device="cuda")
    gen.set_state(state["rng"].get_state())
    return sim._drawn_round_step(state["global_params"], state["prev_genuine"],
                                 state["have_genuine"], gen, 1)


def xla_first_grads(sim: Simulator, params: dict, draws) -> torch.Tensor:
    """|g| [C, P] of every client's first clipped minibatch gradient under
    xla (training/local.py's first step, dropout on)."""
    cfg, model = sim.cfg, sim.model
    B, (C, hi) = cfg.batch_size, draws.idx.shape
    nb = -(-hi // B)
    columns = [sim.train_data[k] for k in local.INPUTS[cfg.data_name]]
    labels = local.labels_of(sim.train_data, cfg.data_name)
    first = lambda x: F.pad(torch.gather(x, 1, draws.perms[0]),  # noqa: E731
                            (0, nb * B - hi)).reshape(C, nb, B)[:, 0]
    bidx, bmsk = first(draws.idx), first(draws.mask.to(torch.float32))
    specs = model.mask_specs([(B,) + tuple(x.shape[1:]) for x in columns], model.dropout_rates)
    keys = tfs.client_keys(draws.dropout_seed, 0, torch.arange(C, device="cuda"))
    grad = local.build_step_grad(model, cfg.data_name, params)
    g, _ = grad(tree_ravel_stacked(tree_broadcast(params, C)), tuple(x[bidx] for x in columns),
                labels[bidx], bmsk, local.step_masks(keys, specs))
    return local.clip_by_global_norm(g, cfg.clip_grad_norm).abs()


def mesh_run(cfg: Config, mesh, rounds: int, meshless: dict | None = None):
    """``rounds`` rounds of ``cfg`` over ``mesh`` (None: no mesh) from a
    fresh state: the Simulator, round 1's state, the final state, the
    history and the kernels' launches over the run."""
    sim = Simulator(cfg, device="cuda", mesh=mesh)
    state = sim.init_state()
    reset_launches()
    one, history = sim.run(num_rounds=1, state=state, save_checkpoints=False, verbose=False)
    final, rest = sim.run(num_rounds=rounds, state=one, save_checkpoints=False, verbose=False)
    torch.cuda.synchronize()
    return sim, one, final, history + rest, launch_counts()


def mesh_pallas_check(mesh) -> tuple[dict, dict]:
    """21b: config 4 (cut) under pallas with threefry keys (shard_map) over
    the mesh against the meshless run: round 1's local update bit for
    bit, the ok sequence, the params after round 1 within MESH_PARAM_TOL,
    K1 launched shards x epochs a broadcast.  Returns the mesh run's
    launches and the meshless run's round-1 rows for 21d."""
    cfg = cut_config(local_backend="pallas", prng_impl="threefry2x32")
    plain, plain_one, plain_final, plain_hist, _ = mesh_run(cfg, None, ROUNDS[1])
    sim, one, final, hist, launches = mesh_run(cfg, mesh, ROUNDS[1])
    draws, rows = first_round(plain, plain.init_state())
    _, mesh_rows = first_round(sim, sim.init_state())
    rows_equal = same_bits(rows[0], mesh_rows[0])
    gap1 = max_param_gap(one["global_params"], plain_one["global_params"])
    gap = max_param_gap(final["global_params"], plain_final["global_params"])
    oks, plain_oks = [h["ok"] for h in hist], [h["ok"] for h in plain_hist]
    expect = {"fused_step": MESH_SHARDS * cfg.epochs * len(hist), "dropout_mask": 0}
    log(f"[21b] pallas, threefry ({sim.mesh_strategy}) over {mesh.size} shards of cuda:0: "
        f"round 1's local update {'bit-equal' if rows_equal else 'DIFFERENT'} to the meshless "
        f"run's; ok {oks} (meshless {plain_oks}); params after round 1 within {gap1:.3g} (tol "
        f"{MESH_PARAM_TOL}), after {len(hist)} rounds {gap:.3g}; launches {launches} "
        f"(expected {expect}); AUC {[round(h['roc_auc'], 4) for h in hist]} ({card_line()})")
    if (sim.mesh_strategy != "shard_map" or not rows_equal or oks != plain_oks
            or gap1 > MESH_PARAM_TOL or launches != expect):
        raise AssertionError("21b: the pallas mesh run differs from the meshless run")
    MESH_REFS["pallas"] = to_cpu({k: final[k] for k in ("global_params", "prev_genuine")})
    return launches, {"sim": plain, "draws": draws, "rows": rows}


def mesh_xla_check(mesh) -> dict:
    """21c: one round of config 4 (cut) under xla with rbg keys (gspmd)
    over the mesh: the local update's rows against the meshless run's
    (bit for bit, or where cuBLAS parts them K1's cold-Adam gate), the
    aggregate within MESH_PARAM_TOL of the meshless aggregate of the same
    rows, the same ok, K3 launched shards x steps."""
    cfg = cut_config(local_backend="xla")
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    plain, plain_one, _, plain_hist, _ = mesh_run(cfg, None, 1)
    sim, one, _, hist, launches = mesh_run(cfg, mesh, 1)
    state = plain.init_state()
    draws, rows = first_round(plain, state)
    _, mesh_rows = first_round(sim, sim.init_state())
    flat, mesh_flat = tree_ravel_stacked(rows[0]), tree_ravel_stacked(mesh_rows[0])
    diff = (flat - mesh_flat).abs()
    if bool(torch.equal(flat, mesh_flat)):
        held, row_err = "bit-equal", 0.0
    else:
        sure = xla_first_grads(plain, state["global_params"], draws) >= GRAD_FLOOR
        row_err = float(diff[sure].max())
        held = (f"not bit-equal (all entries {float(diff.max()):.3g}); on the "
                f"{int(sure.sum())} of {sure.numel()} entries whose first-step |g| >= "
                f"{GRAD_FLOOR:g}: {row_err:.3g} (tol {PARAM_TOL})")
    weights = torch.ones(cfg.total_clients, device="cuda") * (mesh_rows[1] > 0)
    agg = sim.aggregate(state["global_params"], mesh_rows[0], mesh_rows[1], weights, draws)
    ref = plain.aggregate(state["global_params"], mesh_rows[0], mesh_rows[1], weights, draws)
    agg_gap = max_param_gap(agg, ref)
    run_gap = max_param_gap(one["global_params"], plain_one["global_params"])
    expect = {"fused_step": 0, "dropout_mask": MESH_SHARDS * cfg.epochs * nb}
    log(f"[21c] xla, rbg ({sim.mesh_strategy}) over {mesh.size} shards: round 1's rows "
        f"{held}; the aggregate within {agg_gap:.3g} of the meshless aggregate of the same rows "
        f"(tol {MESH_PARAM_TOL}), the round's params within {run_gap:.3g} of the meshless "
        f"round's; ok {hist[0]['ok']} (meshless {plain_hist[0]['ok']}); launches {launches} "
        f"(expected {expect}) ({card_line()})")
    if (sim.mesh_strategy != "gspmd" or row_err > PARAM_TOL or agg_gap > MESH_PARAM_TOL
            or hist[0]["ok"] != plain_hist[0]["ok"] or launches != expect):
        raise AssertionError("21c: the xla mesh round differs from the meshless round")
    MESH_REFS["xla"] = to_cpu({"rows": mesh_rows[0], "params": one["global_params"]})
    return launches


def mesh_defense_check(mesh, round1: dict) -> None:
    """21d: every defense's sharded aggregation on 21b's meshless round-1
    rows against the meshless aggregator: the gather modes bit for bit,
    the psum modes within MESH_AGG_TOL; each one's collectives the table's."""
    from attackfl_tpu_torch.parallel.shard import GATHER_MODES, PSUM_MODES, record_collectives

    plain, (stacked, sizes, *_) = round1["sim"], round1["rows"]
    params = plain.init_state()["global_params"]
    weights = torch.ones(plain.cfg.total_clients, device="cuda") * (sizes > 0)
    lines, failures = [], []
    for mode in sorted(PSUM_MODES | GATHER_MODES):
        cfg = plain.cfg.replace(mode=mode)
        draws = tround.round_drawer(cfg, [], plain.cfg.total_clients, plain.pool_size,
                                    plain.num_params, plain.test_data["label"].shape[0])(
            torch.Generator(device="cuda").manual_seed(5))
        want = tround.build_aggregator(plain.model, cfg, plain.test_data)(
            params, stacked, sizes, weights, draws)
        sharded = tround.build_aggregator(plain.model, cfg, plain.test_data, mesh=mesh)
        with record_collectives() as recorded:
            got = sharded(params, stacked, sizes, weights, draws)
        torch.cuda.synchronize()
        expected = program_audit.EXPECTED_COLLECTIVES[mode]["forward"]
        gap = max_param_gap(got, want)
        exact = same_bits(got, want)
        ok = (exact if mode in GATHER_MODES else gap <= MESH_AGG_TOL) and \
            set(recorded) == set(expected)
        lines.append(f"{mode} {'bit-equal' if exact else f'{gap:.3g}'} "
                     f"[{','.join(sorted(recorded))}]")
        if not ok:
            failures.append(mode)
    log(f"[21d] each defense sharded over {mesh.size} shards on 21b's round-1 rows against "
        f"the meshless aggregator (gather modes bit for bit, psum modes tol {MESH_AGG_TOL}; "
        f"the collectives recorded): {'; '.join(lines)} ({card_line()})")
    if failures:
        raise AssertionError(f"21d: sharded aggregations differ or record other "
                             f"collectives: {failures}")


def mesh_one_device_check() -> dict:
    """21e: the one-device mesh that `run` builds (Simulator(cfg,
    use_mesh=True)) under each backend against the meshless run (phase
    4's where the script ran it): the final params and leak pool bit for
    bit, the same launches."""
    total = Counter()
    for backend in ("pallas", "xla"):
        cfg = cut_config(local_backend=backend)
        plain, launches0 = MAIN_STATES.get(backend), None
        if plain is None:
            _, _, plain, _, launches0 = mesh_run(cfg, None, ROUNDS[1])
        sim = Simulator(cfg, device="cuda", use_mesh=True)
        state = sim.init_state()
        reset_launches()
        final, history = sim.run(state=state, save_checkpoints=False, verbose=False)
        torch.cuda.synchronize()
        launches = launch_counts()
        nb = -(-cfg.num_data_range[1] // cfg.batch_size)
        expect = ({"fused_step": len(history) * cfg.epochs, "dropout_mask": 0}
                  if backend == "pallas" else
                  {"fused_step": 0, "dropout_mask": len(history) * cfg.epochs * nb})
        same = (same_bits(final["global_params"], plain["global_params"])
                and same_bits(final["prev_genuine"], plain["prev_genuine"]))
        log(f"[21e] {backend}: the one-device mesh of `run` ({sim.mesh.size} device, "
            f"{sim.mesh_strategy}) against the meshless run: {'bit-equal' if same else 'DIFFERENT'}"
            f", launches {launches} (meshless {launches0 or expect}) ({card_line()})")
        if sim.mesh.size != torch.cuda.device_count() or not same or launches != expect \
                or (launches0 is not None and launches0 != expect):
            raise AssertionError(f"21e: {backend}'s one-device mesh differs from no mesh")
        total.update(launches)
    return dict(total)


def mesh_matrix_check(root: str, mesh) -> dict:
    """21f: the sweep's cell axis over the mesh (`matrix run --mesh`'s
    executor) against the unsharded sweep: every cell's state bit for bit,
    no collective, K3 launched the fold's calls x steps."""
    from attackfl_tpu_torch.parallel.shard import record_collectives

    base = matrix_base(root, telemetry=TelemetryConfig(enabled=False))
    grid = GridSpec(**MESH_GRID)
    states, launches = {}, {}
    for label, sweep_mesh in (("unsharded", None), ("sharded", mesh)):
        sweep = MatrixRun(base, grid, device="cuda", mesh=sweep_mesh)
        reset_launches()
        t0 = time.perf_counter()
        with record_collectives() as recorded, contextlib.redirect_stdout(io.StringIO()):
            sweep.run(save_checkpoints=False, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[label] = launch_counts()
        states[label] = sweep.host_state(sweep.state)
        nb = -(-base.num_data_range[1] // base.batch_size)
        expect = sweep.fold_calls * base.epochs * nb
        log(f"[21f] {label} sweep of {len(sweep.device_cells)} device cells in {seconds:.2f} s: "
            f"K3 {launches[label]['dropout_mask']} launches (the fold's {sweep.fold_calls} calls "
            f"x {base.epochs * nb} steps = {expect}), collectives {dict(recorded) or 'none'}")
        sweep.close()
        if launches[label]["dropout_mask"] != expect or recorded:
            raise AssertionError(f"21f: the {label} sweep's launches or collectives")
    diffs = [key for key in states["unsharded"]
             if first_difference(states["unsharded"][key], states["sharded"][key])]
    log(f"[21f] `matrix run --mesh` over {mesh.size} shards: "
        f"{len(states['unsharded']) - len(diffs)} of {len(states['unsharded'])} cells bit-equal "
        f"to the unsharded sweep's ({card_line()})")
    if diffs:
        raise AssertionError(f"21f: sharded cells differ: {diffs}")
    return launches["sharded"]


def mesh_audit_check() -> None:
    """21g: the sharded programs and the cell-sharded sweep under the
    program audit on the card: no host sync, the table's collectives."""
    reports = (program_audit.audit_sharded_programs(device="cuda", shards=MESH_SHARDS)
               + program_audit.audit_sharded_matrix_program(device="cuda", shards=MESH_SHARDS))
    log("[21g] the program audit of the client mesh's programs on the card: " + "; ".join(
        f"{r.name} {'ok' if r.ok else 'FAIL'} syncs {len(r.syncs)} collectives "
        f"[{','.join(r.collectives)}] (expected [{','.join(r.expected_collectives)}]) "
        f"{r.wall_ms:.1f} ms" for r in reports) + f" ({card_line()})")
    bad = [r.name for r in reports if not r.ok or r.syncs or
           set(r.collectives) != set(r.expected_collectives)]
    if bad:
        raise AssertionError(f"21g: {bad}: {[r.problems for r in reports if not r.ok][:2]}")


def mesh_phase() -> dict:
    """Phase 21: a-g.  Returns the kernels' launches in b's, c's and e's
    mesh runs and f's sharded sweep (not their meshless references', nor
    a's, d's and g's checks)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    total = Counter()
    try:
        mesh = mesh_of(MESH_SHARDS)
        marks = [time.perf_counter()]
        mesh_k1_check()
        marks.append(time.perf_counter())
        launches, round1 = mesh_pallas_check(mesh)
        total.update(launches)
        marks.append(time.perf_counter())
        total.update(mesh_xla_check(mesh))
        marks.append(time.perf_counter())
        mesh_defense_check(mesh, round1)
        marks.append(time.perf_counter())
        total.update(mesh_one_device_check())
        marks.append(time.perf_counter())
        total.update(mesh_matrix_check(root, mesh))
        marks.append(time.perf_counter())
        mesh_audit_check()
        marks.append(time.perf_counter())
        log("[phase 21] " + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in
                                      zip("abcdefg", marks, marks[1:]))
            + f", in all {marks[-1] - marks[0]:.1f} s; launches {dict(total)} ({card_line()})")
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 22: the client mesh over MP_RANKS processes (ROADMAP item 14b), each
# rank a shard of cuda:0, joined over 127.0.0.1; the pair of ranks has
# MP_TIMEOUT seconds and is killed after it
MP_RANKS, MP_TIMEOUT = 2, 300


def mp_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_spawn(argvs: list, cwds: list, env: dict):
    """The ranks, started together as fresh interpreters (never forked
    from this process, which holds a CUDA context)."""
    return [subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for argv, cwd in zip(argvs, cwds)]


def mp_finish(procs: list) -> list:
    """Each rank's CHILD record, once every rank exited 0; a rank still
    running after MP_TIMEOUT is killed, and so is every rank when one
    call fails."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MP_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    records = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("CHILD ")]
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"22: rank {rank} exited {rc}:\n{out[-3000:]}\n{err[-3000:]}")
        records.append(dict(json.loads(lines[0][len("CHILD "):]), out=out))
    return records


def mp_child(argv: list) -> int:
    """A rank of phase 22 (``chip_smoke.py --child COORDINATOR RANK ROOT
    -- ARGS``): a. ``python -m attackfl_tpu_torch ARGS`` (a `run
    --coordinator` of its own group) in this process, in its launch
    directory; then, joined again at COORDINATOR, b (xla, rbg: gspmd,
    one round), b' (pallas, threefry: shard_map, ROUNDS[1] rounds) and c
    (a ``load_parameters`` restart of a's launch).  It prints its CHILD
    record, the kernels' launches of a, b and b' as it counted them, and
    saves the states the parent compares into ROOT."""
    import torch.distributed as dist

    from attackfl_tpu_torch.parallel.mesh import distributed_init, make_client_mesh

    coordinator, rank, root = argv[0], int(argv[1]), argv[2]
    resolve_device("cuda")
    reset_launches()
    rc = cli.main(argv[argv.index("--") + 1:])
    torch.cuda.synchronize()
    record, saved = {"rc": rc, "cli": launch_counts()}, {}
    if rc != 0:
        print("CHILD " + json.dumps(record), flush=True)
        return rc
    # b's and c's telemetry stays out of a's directory
    os.environ["ATTACKFL_TELEMETRY_DIR"] = os.path.join(root, "mesh-events")
    distributed_init(coordinator, MP_RANKS, rank)
    try:
        mesh = make_client_mesh(0, device="cuda")
        record["mesh"] = [mesh.size, list(mesh.processes)]
        for label, cfg, rounds in (
                ("xla", cut_config(local_backend="xla"), 1),
                ("pallas", cut_config(local_backend="pallas", prng_impl="threefry2x32"),
                 ROUNDS[1])):
            sim, one, final, history, launches = mesh_run(cfg, mesh, rounds)
            record[label] = {"strategy": sim.mesh_strategy, "launches": launches,
                             "ok": [bool(h["ok"]) for h in history],
                             "auc": [h["roc_auc"] for h in history]}
            if label == "xla":
                _, rows = first_round(sim, sim.init_state())
                saved["xla"] = to_cpu({"rows": rows[0], "params": one["global_params"]})
            else:
                saved["pallas"] = to_cpu({k: final[k] for k in ("global_params",
                                                                "prev_genuine")})
        cfg = load_config(os.path.join(root, "launch", "config4.yaml")).replace(
            load_parameters=True, telemetry=TelemetryConfig(enabled=False))
        sim = Simulator(cfg, device="cuda", use_mesh=True)
        state = sim.load_or_init_state()
        record["restart"] = {"loaded_bytes": sim.loaded_bytes, "mesh": sim.mesh.size,
                             "completed_rounds": int(state["completed_rounds"])}
        saved["restart"] = to_cpu(sim.host_state(state))
        torch.save(saved, os.path.join(root, f"mesh{rank}.pt"))
        print("CHILD " + json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def mp_launch_check(root: str, records: list, ref: dict) -> dict:
    """22a: the two `python -m attackfl_tpu_torch run --coordinator` ranks
    of config 4 (cut) under pallas, each in its own directory, telemetry
    into one: process 0's checkpoint against the 2-shard single-process
    run of the same config file (``ref``) bit for bit, rank 1 writing
    none, one ok and AUC sequence, K1 ranks x epochs x rounds.  The
    config file takes no key implementation, so the ranks run rbg keys
    (gspmd) and the reference does too.  Returns the ranks' launches."""
    launch = os.path.join(root, "launch")
    rounds = [re.findall(r"Round (\d+) done in [0-9.]+s roc_auc=([0-9.]+)", r["out"])
              for r in records]
    saved = ckpt.load_state(os.path.join(launch, "rank0", "TransformerModel.pth"), ref["want"])
    diff = first_difference(ref["want"], saved)
    elsewhere = [n for n in os.listdir(os.path.join(launch, "rank1")) if n.endswith(".pth")]
    launches = Counter()
    for record in records:
        launches.update(record["cli"])
    expect = {"fused_step": MP_RANKS * ref["epochs"] * ROUNDS[1], "dropout_mask": 0}
    log(f"[22a] `run --coordinator` x {MP_RANKS} ranks of cuda:0, config 4 (cut), pallas, "
        f"rbg (gspmd): process 0's checkpoint "
        f"{'bit-equal' if diff is None else f'DIFFERENT at {diff}'} to the 2-shard "
        f"single-process run; rank 1 wrote {elsewhere or 'no checkpoint'}; (round, AUC) by "
        f"rank {rounds} (single process {ref['rounds']}); launches {dict(launches)} "
        f"(expected {expect}) ({card_line()})")
    if (diff is not None or elsewhere or rounds[0] != rounds[1] or rounds[0] != ref["rounds"]
            or dict(launches) != expect):
        raise AssertionError("22a: the two-process launch differs from the one-process mesh")
    return dict(launches)


def mp_mesh_check(root: str, records: list) -> dict:
    """22b and c: b, one round under xla (rbg, gspmd) over the two-process
    mesh: the gathered rows and the params against phase 21c's 2-shard
    run bit for bit, K3 ranks x steps; b', pallas with threefry
    (shard_map): the final state against phase 21b's bit for bit, K1
    ranks x epochs x rounds; c, a `load_parameters` restart of 22a's
    launch: each rank restores process 0's broadcast bytes, rank 1 with
    no file of its own, both states the checkpoint's bit for bit.
    Returns b's and b''s launches."""
    saved = [torch.load(os.path.join(root, f"mesh{r}.pt"), weights_only=False)
             for r in range(MP_RANKS)]
    cfg = cut_config(local_backend="xla")
    nb = -(-cfg.num_data_range[1] // cfg.batch_size)
    k3 = sum(r["xla"]["launches"]["dropout_mask"] for r in records)
    k1 = sum(r["pallas"]["launches"]["fused_step"] for r in records)
    xla = [first_difference(MESH_REFS["xla"], s["xla"]) for s in saved]
    pallas = [first_difference(MESH_REFS["pallas"], s["pallas"]) for s in saved]
    log(f"[22b] xla, rbg ({records[0]['xla']['strategy']}) over the {records[0]['mesh']} "
        f"mesh, one round: rows and params against 21c's 2-shard run "
        f"{['bit-equal' if d is None else f'DIFFERENT at {d}' for d in xla]} by rank, ok "
        f"{[r['xla']['ok'] for r in records]}, K3 {k3} (expected {MP_RANKS * cfg.epochs * nb}); "
        f"pallas, threefry ({records[0]['pallas']['strategy']}), {ROUNDS[1]} rounds: the final "
        f"state against 21b's {['bit-equal' if d is None else f'DIFFERENT at {d}' for d in pallas]}"
        f", AUC {[r['pallas']['auc'] for r in records]}, K1 {k1} (expected "
        f"{MP_RANKS * cfg.epochs * ROUNDS[1]}) ({card_line()})")
    if (any(d is not None for d in xla + pallas) or k3 != MP_RANKS * cfg.epochs * nb
            or k1 != MP_RANKS * cfg.epochs * ROUNDS[1]
            or records[0]["xla"]["strategy"] != "gspmd"
            or records[0]["pallas"]["strategy"] != "shard_map"
            or records[0]["pallas"]["auc"] != records[1]["pallas"]["auc"]):
        raise AssertionError("22b: the two-process mesh differs from the one-process mesh")
    path = os.path.join(root, "launch", "rank0", "TransformerModel.pth")
    size = os.path.getsize(path)
    restored = [ckpt.load_state(path, s["restart"]) for s in saved]
    diffs = [first_difference(r, s["restart"]) for r, s in zip(restored, saved)]
    restarts = [r["restart"] for r in records]
    log(f"[22c] `load_parameters` restart of 22a's launch: bytes received by rank "
        f"{[r['loaded_bytes'] for r in restarts]} against the file's {size}, completed rounds "
        f"{[r['completed_rounds'] for r in restarts]}, states against the checkpoint "
        f"{['bit-equal' if d is None else f'DIFFERENT at {d}' for d in diffs]} ({card_line()})")
    if (any(r["loaded_bytes"] != size or r["completed_rounds"] != ROUNDS[1]
            or r["mesh"] != MP_RANKS for r in restarts) or any(d is not None for d in diffs)):
        raise AssertionError("22c: a rank did not restore process 0's checkpoint")
    return {"fused_step": k1, "dropout_mask": k3}


def mp_telemetry_check(events: str) -> None:
    """22d: the launch's events.0.jsonl and events.1.jsonl under one
    run_id, each with its own run_header stamped with its process_index;
    `metrics --merge` over them exits 0 with a skew report."""
    names = sorted(n for n in os.listdir(events) if n.startswith("events"))
    run_ids, headers = set(), {}
    for name in names:
        records = load_events(os.path.join(events, name))
        run_ids |= {r["run_id"] for r in records}
        headers[name] = [r.get("process_index") for r in records if r["kind"] == "run_header"]
    rc, out, seconds = run_command(["metrics", events, "--merge", "--json"])
    skew = json.loads(out)["skew"] if rc == 0 else {}
    log(f"[22d] {names} under run ids {sorted(run_ids)}, run_header process_index by file "
        f"{headers}; `metrics --merge` exit {rc} in {seconds:.2f} s: rounds compared "
        f"{skew.get('rounds_compared')}, completion skew {skew.get('completion_skew_s')} s, "
        f"phase lag {skew.get('phase_lag_s')} ({card_line()})")
    if (names != ["events.0.jsonl", "events.1.jsonl"] or len(run_ids) != 1
            or headers != {"events.0.jsonl": [0], "events.1.jsonl": [1]} or rc != 0
            or not skew.get("rounds_compared") or not skew.get("phase_lag_s")):
        raise AssertionError("22d: the per-process telemetry or its merge")


def multiprocess_phase() -> dict:
    """Phase 22: a-d, one pair of ranks for a, b and c; the references,
    here, while the ranks run.  Returns the kernels' launches in the
    ranks' a and b, as each rank counted them."""
    root = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    launch, events = os.path.join(root, "launch"), os.path.join(root, "events")
    total = Counter()
    try:
        t0 = time.perf_counter()
        for rank in range(MP_RANKS):
            os.makedirs(os.path.join(launch, f"rank{rank}"))
        yaml_path = config4_yaml(os.path.join(launch, "config4.yaml"), "pallas", ".")
        cli_coordinator, mesh_coordinator = (f"127.0.0.1:{mp_free_port()}" for _ in range(2))
        procs = mp_spawn([[sys.executable, os.path.abspath(__file__), "--child",
                           mesh_coordinator, str(rank), root, "--", "run", "--config", yaml_path,
                           "--device", "cuda", "--coordinator", cli_coordinator,
                           "--num-processes", str(MP_RANKS), "--process-id", str(rank)]
                          for rank in range(MP_RANKS)],
                         [os.path.join(launch, f"rank{r}") for r in range(MP_RANKS)],
                         {**os.environ, "ATTACKFL_TELEMETRY_DIR": events})
        try:
            if "xla" not in MESH_REFS or "pallas" not in MESH_REFS:
                mesh_pallas_check(mesh_of(MP_RANKS))
                mesh_xla_check(mesh_of(MP_RANKS))
            cfg = load_config(yaml_path).replace(telemetry=TelemetryConfig(enabled=False),
                                                 log_path=os.path.join(root, "ref"),
                                                 checkpoint_dir=os.path.join(root, "ref"))
            sim = Simulator(cfg, device="cuda", mesh=mesh_of(MP_RANKS))
            final, history = sim.run(state=sim.init_state(), save_checkpoints=False,
                                     verbose=False)
            ref = {"want": to_cpu(sim.host_state(final)), "epochs": cfg.epochs,
                   "rounds": [(str(h["round"]), f"{h['roc_auc']:.4f}") for h in history]}
        finally:
            records = mp_finish(procs)
        ranks_s = time.perf_counter() - t0
        total.update(mp_launch_check(root, records, ref))
        total.update(mp_mesh_check(root, records))
        mp_telemetry_check(events)
        log(f"[phase 22] {time.perf_counter() - t0:.1f} s, the ranks {ranks_s:.1f} s of it; "
            f"launches {dict(total)} ({card_line()})")
    finally:
        shutil.rmtree(root)
    return dict(total)


# phase 23: BASELINE config 4 at full scale, the workload of the JAX
# package's own 30-round CPU run (scripts/full_parity_jax.py
# full_scale_config(30): bench.py:93-98 with 25 LIE attackers), through the
# port's `run` command; its final AUC within FULL_AUC_TOL of
# FULL_PARITY_JAX.json's, and a gap above FULL_AUC_SPREAD, the widest
# between the packages in ROADMAP's seed table, reported as a finding
FULL_SCALE = dict(CONFIG4, **DEPTH["full"], num_round=ROUNDS[0])
FULL_AUC_TOL, FULL_AUC_SPREAD = 0.02, 0.008
# the rounds of full_parity_jax.log that carry their own AUC (its first
# chunk ran rounds 1-16)
JAX_LOGGED_ROUNDS = range(16, ROUNDS[0] + 1)
# K1's first launches of the run held against its plain version at their
# full depth (118 steps): epoch 0 from the cold Adam state, epoch 1 warm
FULL_K1_HELD = 2


def full_scale_config(backend: str = "pallas", seed: int = 1, log_path: str = ".") -> Config:
    """Phase 23's config: FULL_SCALE under ``backend`` at ``seed``,
    logging and checkpointing into ``log_path``."""
    return Config(**{**FULL_SCALE, "local_backend": backend, "random_seed": seed,
                     "log_path": log_path, "checkpoint_dir": log_path})


def jax_full_scale() -> tuple[float, dict]:
    """The JAX package's run of phase 23's workload: FULL_PARITY_JAX.json's
    final ROC-AUC and full_parity_jax.log's AUC by round."""
    with open(os.path.join(REPO, "FULL_PARITY_JAX.json")) as fh:
        final = json.load(fh)["final_roc_auc"]
    with open(os.path.join(REPO, "full_parity_jax.log")) as fh:
        rounds = {int(n): float(auc) for n, auc in re.findall(
            r"\b(\d+)/\d+ rounds, chunk of \d+ .*? roc_auc=([0-9.]+)", fh.read())}
    if sorted(rounds) != list(JAX_LOGGED_ROUNDS):
        raise AssertionError(f"full_parity_jax.log: rounds {sorted(rounds)}")
    return final, rounds


@contextlib.contextmanager
def captured_epochs(n: int):
    """Clones of the arguments of the first ``n`` K1 launches made inside
    the block, taken before each launch updates p, m and v in place."""
    real, seen = tfs._run_epoch, []

    def spy(p, m, v, batches, seed, t_offset, **kw):
        if len(seen) < n and batches.is_cuda:
            seen.append((clone_groups(p), clone_groups(m), clone_groups(v), batches.clone(),
                         seed.clone() if isinstance(seed, torch.Tensor) else seed, t_offset, kw))
        return real(p, m, v, batches, seed, t_offset, **kw)

    tfs._run_epoch = spy
    try:
        yield seen
    finally:
        tfs._run_epoch = real


def hold_full_scale_epochs(captured: list, label: str) -> float:
    """Phase 23's first K1 launches (round 1's epoch 0 from the cold Adam
    state, epoch 1 from the warm one) against run_epoch_reference on their
    own batches, dropout seed, step offset and client base, with the run's
    dropout and with dropout off, at check_fused_step's tolerances: from
    the cold state p is gated where the first step's float64 gradient is
    at least GRAD_FLOOR.  Returns the largest error."""
    failures, worst = [], 0.0
    for p, m, v, batches, seed, t0, kw in captured:
        nb = batches.shape[1]
        state = "cold" if max_abs(m) == 0.0 else "warm"
        for rates in ((kw["drop_attn"], kw["drop_block"], kw["drop_head"]), (0.0, 0.0, 0.0)):
            step = dict(kw, drop_attn=rates[0], drop_block=rates[1], drop_head=rates[2])
            *k, kloss = tfs.run_epoch(*map(clone_groups, (p, m, v)), batches, seed, t0, **step)
            *r, rloss = tfs.run_epoch_reference(*map(clone_groups, (p, m, v)), batches, seed, t0,
                                                **step)
            torch.cuda.synchronize()
            sure, note = None, ""
            if state == "cold":
                p64 = {key: x.double() for key, x in p.items()}
                _, m1, _, _ = tfs.run_epoch_reference(
                    p64, tfs.zeros_like_groups(p64), tfs.zeros_like_groups(p64),
                    batches[:, :1].double(), seed, t0, **step)
                sure = {key: x.abs() / (1.0 - tfs.B1) >= GRAD_FLOOR for key, x in m1.items()}
                note = f"; p on all entries {max_abs(k[0], r[0]):.3g}"
            p_err, m_err, v_err = max_abs(k[0], r[0], sure), max_abs(k[1], r[1]), max_abs(k[2], r[2])
            m_tol, v_tol = MV_RTOL * max_abs(r[1]), MV_RTOL * max_abs(r[2])
            loss_err = float((kloss - rloss).abs().max()) / nb
            worst = max(worst, p_err, m_err, v_err)
            log(f"[full] {label} K1 launch at t0={t0} ({state} state, nb={nb}) dropout={rates}: "
                f"max |kernel - plain| p {p_err:.3g} (tol {PARAM_TOL}), m {m_err:.3g} (tol "
                f"{m_tol:.3g}), v {v_err:.3g} (tol {v_tol:.3g}), loss/step {loss_err:.3g} (tol "
                f"{LOSS_TOL_PER_STEP}){note}")
            if not (bool(torch.isfinite(kloss).all()) and p_err <= PARAM_TOL and m_err <= m_tol
                    and v_err <= v_tol and loss_err <= LOSS_TOL_PER_STEP):
                failures.append(f"K1 differs from its plain version ({state} state, dropout "
                                f"{rates})")
    if len(captured) != FULL_K1_HELD or failures:
        raise AssertionError(f"{label}: {len(captured)} launches held; {'; '.join(failures)}")
    return worst


def full_scale_phase(backend: str = "pallas", seed: int = 1) -> dict:
    """Phase 23: config 4 at full scale (30 rounds, 5 epochs, 12,000-15,000
    samples a client) under ``backend`` at ``seed``, written as a config
    file and run in this process through ``python -m attackfl_tpu_torch
    run --config``; its rounds read from the run's events.  Gates: exit 0,
    every round ok, the final AUC within FULL_AUC_TOL of the JAX package's,
    K1 epochs a round under pallas (K3 once a step under xla).  Returns the
    run's kernel launches."""
    jax_final, jax_rounds = jax_full_scale()
    root = tempfile.mkdtemp(prefix="chip_smoke_full_")
    try:
        cfg = full_scale_config(backend, seed, root)
        path = config_yaml(os.path.join(root, "config4_full.yaml"), cfg, root)
        reset_launches()
        t0 = time.perf_counter()
        held = FULL_K1_HELD if backend == "pallas" else 0
        with contextlib.redirect_stdout(io.StringIO()), captured_epochs(held) as captured:
            rc = cli.run_main(["--config", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        rounds = [e for e in read_events(root) if e["kind"] == "round"]
    finally:
        shutil.rmtree(root)
    label = f"full scale {backend} seed {seed}"
    for e in rounds:
        jax_auc = jax_rounds.get(e["round"])
        beside = "" if jax_auc is None else (f" (JAX {jax_auc:.4f}, port - JAX "
                                             f"{e['roc_auc'] - jax_auc:+.4f})")
        log(f"[full] {label} round {e['round']} ok={e['ok']} roc_auc={e['roc_auc']:.4f}"
            f"{beside} train_loss={e['train_loss']:.4f} seconds={e['seconds']:.4f}")
    ok = [e["ok"] for e in rounds]
    final = rounds[-1]["roc_auc"] if rounds else float("nan")
    gap = final - jax_final
    walls = [e["seconds"] for e in rounds] or [float("nan")]
    finding = (f", beyond the seed spread {FULL_AUC_SPREAD}: a finding"
               if abs(gap) > FULL_AUC_SPREAD else "")
    log(f"[full] {label}: exit {rc}, {sum(ok)} of {len(ok)} rounds ok, final ROC-AUC "
        f"{final:.4f} against the JAX package's {jax_final} (port - JAX {gap:+.4f}; gate "
        f"{FULL_AUC_TOL}{finding}); wall s/round mean {sum(walls) / len(walls):.4f}, min "
        f"{min(walls):.4f}, max {max(walls):.4f}; launches {launches}; phase {seconds:.1f} s "
        f"(construction included) ({card_line()})")
    if rc != 0 or len(ok) != cfg.num_round or not all(ok):
        raise AssertionError(f"{label}: exit {rc}, rounds ok {ok}")
    if not abs(gap) <= FULL_AUC_TOL:
        raise AssertionError(f"{label}: final ROC-AUC {final} against JAX's {jax_final}")
    require_kernel(label, cfg, launches, len(rounds))
    if held:
        t0 = time.perf_counter()
        err = hold_full_scale_epochs(captured, label)
        PHASE_ERRORS["fused_step"] = max(PHASE_ERRORS.get("fused_step", 0.0), err)
        log(f"[full] {label}: K1's first {held} launches held in {time.perf_counter() - t0:.1f} s")
    return {k: v for k, v in launches.items() if v}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        # a rank of phase 22, started by the phase itself
        return mp_child(argv[1:])
    parser = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    parser.add_argument("--only", type=int, default=None, metavar="PHASE",
                        help="after the build, run only this phase of 12-23 and print no "
                             "result line (a development run)")
    parser.add_argument("--backend", choices=("pallas", "xla"), default="pallas",
                        help="phase 23's local backend (with --only 23)")
    parser.add_argument("--seed", type=int, default=1,
                        help="phase 23's random seed (with --only 23)")
    parser.add_argument("--fixtures", type=str, default=None, metavar="DIR",
                        help="write phase 16's golden traces for the CPU tests into DIR")
    args = parser.parse_args(argv)
    if (args.backend, args.seed) != ("pallas", 1) and args.only != 23:
        parser.error("--backend and --seed are phase 23's: they need --only 23")
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

    if args.only is not None:
        phase = {12: fused_phase, 13: pipeline_phase, 14: telemetry_phase,
                 15: numerics_phase, 16: lambda: hotspots_phase(args.fixtures),
                 17: matrix_phase, 18: audit_phase, 19: grad_phase,
                 20: service_phase, 21: mesh_phase, 22: multiprocess_phase,
                 23: lambda: full_scale_phase(args.backend, args.seed)}[args.only]
        t0 = time.perf_counter()
        log(f"[only] phase {args.only}: launches {phase()} in {time.perf_counter() - t0:.1f} "
            f"s; no result line")
        return 0

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
                        ("faults, dtypes, async", lambda: faults_dtypes_async_phase(card)),
                        ("fused path and launch surface", fused_phase)):
        t0 = time.perf_counter()
        phase()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipeline_launches = pipeline_phase()
    log(f"[pipelined executor] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    telemetry_launches = telemetry_phase()
    log(f"[telemetry and ledger] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    numerics_launches = numerics_phase()
    log(f"[numerics and monitor] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hotspot_launches = hotspots_phase(args.fixtures)
    log(f"[hotspots and cost model] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    matrix = matrix_phase()
    log(f"[scenario matrix] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    audit_launches = audit_phase()
    log(f"[audit, guard, ledger and science] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grad_launches = grad_phase()
    log(f"[transform-safety auditor] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    service_launches = service_phase()
    log(f"[run service and scheduler] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_launches = mesh_phase()
    log(f"[client mesh] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multiprocess_launches = multiprocess_phase()
    log(f"[client mesh over processes] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full_launches = full_scale_phase()
    log(f"[config 4 at full scale] phase done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches"] += (pipeline_launches.get(k["name"], 0)
                          + telemetry_launches.get(k["name"], 0)
                          + numerics_launches.get(k["name"], 0)
                          + hotspot_launches.get(k["name"], 0)
                          + audit_launches.get(k["name"], 0)
                          + grad_launches.get(k["name"], 0)
                          + service_launches.get(k["name"], 0)
                          + mesh_launches.get(k["name"], 0)
                          + multiprocess_launches.get(k["name"], 0)
                          + full_launches.get(k["name"], 0))
        k["max_abs_err"] = max(k["max_abs_err"], PHASE_ERRORS.get(k["name"], 0.0))
        if k["name"] == "dropout_mask":
            k["launches"] += matrix["launches"]
            k["max_abs_err"] = max(k["max_abs_err"], matrix["max_abs_err"])
    log(f"[done] all phases in {time.perf_counter() - started:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
