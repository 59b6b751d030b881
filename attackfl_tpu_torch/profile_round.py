"""Where a main-path round's time goes on the GPU.

    python -m attackfl_tpu_torch.profile_round            # config 4, depth cut: 3 rounds
    python -m attackfl_tpu_torch.profile_round --full     # config 4 at full depth: 1 round
    python -m attackfl_tpu_torch.profile_round --backend xla   # the torch-autograd path

Runs BASELINE config 4 (ICU TransformerModel, 100 clients, 25 LIE
attackers, fedavg; BASELINE.md:37) on the card with ``--backend pallas``
(the fused kernel K1, the default) or ``xla`` (torch autograd, dropout
masks from kernel K3): one warm-up round, then the profiled rounds under
``torch.profiler``.  Prints the card's name
and power limit, the wall seconds per round, the device-busy seconds per
round (the sum of GPU kernel and copy time), the idle share, and the
device time by kernel, then one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from attackfl_tpu_torch import device as devices
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.training.engine import Simulator

# BASELINE config 4 at its published width and client count; chip_smoke.py
# runs the "cut" depth
CONFIG4 = dict(total_clients=100, mode="fedavg", model="TransformerModel",
               data_name="ICU", batch_size=128, lr=0.004, clip_grad_norm=1.0,
               genuine_rate=0.5, train_size=20000, test_size=4000,
               local_backend="pallas", random_seed=1,
               attacks=(AttackSpec(mode="LIE", num_clients=25, attack_round=2,
                                   args=(0.74,)),))
DEPTH = {"cut": dict(epochs=2, num_data_range=(1200, 1500)),
         "full": dict(epochs=5, num_data_range=(12000, 15000))}
PROFILED_ROUNDS = {"cut": 3, "full": 1}
TOP = 12
PORT_KERNELS = ("train_epoch_kernel", "fill_masks")    # K1, K3


def self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="full depth: 12000-15000 samples per client, 5 epochs")
    parser.add_argument("--backend", choices=("pallas", "xla"), default="pallas",
                        help="local_backend of the profiled rounds (default pallas)")
    args = parser.parse_args(argv)
    depth = "full" if args.full else "cut"
    rounds = PROFILED_ROUNDS[depth]

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = Config(**{**CONFIG4, "local_backend": args.backend}, **DEPTH[depth],
                 num_round=rounds + 1)
    sim = Simulator(cfg, device="cuda")
    state, _ = sim.run_round(sim.init_state())          # warm-up: build, caches
    devices.synchronize("cuda")

    history = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, metrics = sim.run_round(state)
            history.append(metrics)
        devices.synchronize("cuda")
        wall = time.perf_counter() - t0

    # device-side entries only (kernels, copies): an operator's entry
    # repeats the device time of the kernels it launched
    by_name, launches = {}, 0
    for evt in prof.key_averages():
        us = self_device_us(evt)
        if us > 0 and evt.device_type != DeviceType.CPU:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
            launches += evt.count
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # the port's own kernels, wherever they rank
    ours = {name: us for name, us in by_name.items()
            if any(k in name for k in PORT_KERNELS)}
    print(card)
    print(f"config 4, local_backend {args.backend}, depth {depth} {DEPTH[depth]}: "
          f"{rounds} profiled rounds, ok "
          f"{[h['ok'] for h in history]}, roc_auc {[round(h.get('roc_auc', float('nan')), 4) for h in history]}")
    print(f"wall {wall / rounds:.4f} s/round, device busy {busy_s / rounds:.4f} s/round, "
          f"idle share {1 - busy_s / wall:.3f}, {launches / rounds:.0f} device kernels "
          f"and copies per round")
    for name, us in top:
        print(f"  {us / 1e3 / rounds:10.3f} ms/round  {us / 1e6 / busy_s:6.1%}  {name[:90]}")
    for name, us in ours.items():
        print(f"  port kernel: {us / 1e3 / rounds:10.3f} ms/round  {us / 1e6 / busy_s:6.1%}  "
              f"{name[:90]}")
    print(json.dumps({
        "card": card, "backend": args.backend, "depth": depth, "rounds": rounds,
        "wall_s_per_round": wall / rounds, "device_busy_s_per_round": busy_s / rounds,
        "idle_share": 1 - busy_s / wall if busy_s > 0 else None,
        "device_launches_per_round": launches / rounds,
        "top_ms_per_round": {name[:90]: us / 1e3 / rounds for name, us in top},
        "port_kernels_ms_per_round": {name[:90]: us / 1e3 / rounds for name, us in ours.items()},
        "ok": [h["ok"] for h in history]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
