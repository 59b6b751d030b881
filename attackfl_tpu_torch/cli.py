"""``python -m attackfl_tpu_torch``: the port's launchers, mirroring
``python -m attackfl_tpu`` (``attackfl_tpu/cli.py``).

The reference is started as one ``server.py`` and N ``client.py``
processes (README.md:91-143).  Here the federation runs in one process,
and the same workflow goes through a file rendezvous, the JAX package's
byte for byte: each ``client`` writes a registration (client id and
attack flags) into ``.registrations/`` beside the config and exits;
``server`` waits until ``server.clients`` registrations are there, turns
the attacking ones into the run's attackers, and runs the federation on
the card.  ``server --no-wait``, and ``run``, which is the same, skip the
rendezvous and take the attackers from the config's ``attack-clients``
section.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import uuid

from attackfl_tpu_torch.telemetry.console import print_with_color

REG_DIR = ".registrations"

_USAGE = """usage: python -m attackfl_tpu_torch <command> [options]

commands:
  server   wait for `server.clients` registrations beside the config, then
           run the federation with their attackers (--config PATH,
           --device cuda|cpu, --no-wait, --rounds N, --pipeline,
           --pipeline-depth K|auto, --resume, --checkpoint-async,
           --inject-faults PLAN, --validation-every K, --validation-async,
           --compile-cache DIR; not ported yet, each refused with its
           ROADMAP item: --monitor, --monitor-port N, --profile-rounds A:B,
           --hotspots A:B, --numerics, --coordinator HOST:PORT with
           --num-processes and --process-id)
  client   register one client for the server (--config PATH, --attack
           [True], --attack_mode MODE, --attack_round N, --attack_args X..)
  run      server --no-wait: attackers from the config's attack-clients
"""


def _registration_dir(base: str) -> str:
    path = os.path.join(base, REG_DIR)
    os.makedirs(path, exist_ok=True)
    return path


def client_main(argv=None) -> int:
    """Reference client flags (client.py:19-38) -> a registration file
    (JAX cli.py:56-97)."""
    parser = argparse.ArgumentParser(prog="python -m attackfl_tpu_torch client",
                                     description="attackfl_tpu_torch client launcher")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--device", type=str, required=False,
                        help="accepted for parity; unused")
    # the bare `--attack` and the reference's `--attack True`: client.py:21
    # takes argparse type=bool, which reads ANY string, "False" too, as
    # true, so the text is parsed instead
    parser.add_argument("--attack", nargs="?", const=True, default=False,
                        type=lambda s: str(s).strip().lower() in ("true", "1", "yes"))
    parser.add_argument("--attack_mode", type=str,
                        choices=["Random", "Min-Max", "Min-Sum", "Opt-Fang", "LIE"])
    parser.add_argument("--attack_round", type=int)
    parser.add_argument("--attack_args", type=float, nargs="+")
    args = parser.parse_args(argv)

    if args.attack and not args.attack_mode:
        print("Error: --attack_mode is required when --attack is True.")
        return 1
    if args.attack and not args.attack_round:
        print("Error: --attack_round is required when --attack is True.")
        return 1

    client_id = str(uuid.uuid4())
    reg = {
        "client_id": client_id,
        "attack": bool(args.attack),
        "attack_mode": args.attack_mode,
        "attack_round": args.attack_round,
        "attack_args": args.attack_args or [],
    }
    reg_dir = _registration_dir(os.path.dirname(os.path.abspath(args.config)))
    path = os.path.join(reg_dir, f"{client_id}.json")
    tmp = path + ".tmp"          # published whole: the server polls the directory
    with open(tmp, "w") as fh:
        json.dump(reg, fh)
    os.replace(tmp, path)
    print_with_color("[>>>] Client sending registration message to server...", "red")
    print(f"Client ID: {client_id}")
    print(f"Attack: {reg['attack']}, Mode: {reg['attack_mode']}")
    return 0


def _collect_registrations(cfg, base: str, timeout: float = 600.0) -> list[dict]:
    """Wait for ``cfg.total_clients`` registrations under ``base``, read in
    sorted file-name order; then empty the directory (the reference's
    queue hygiene, delete_old_queues) and return the first
    ``total_clients``.  TimeoutError after ``timeout`` seconds."""
    reg_dir = _registration_dir(base)
    print_with_color(f"Server is waiting for {cfg.total_clients} clients.", "green")
    deadline = time.time() + timeout
    while True:
        regs = []
        for name in sorted(os.listdir(reg_dir)):
            if name.endswith(".json"):
                try:
                    with open(os.path.join(reg_dir, name)) as fh:
                        regs.append(json.load(fh))
                except (json.JSONDecodeError, OSError):
                    continue         # mid-write or gone: the next poll reads it
        if len(regs) >= cfg.total_clients:
            for name in os.listdir(reg_dir):
                os.unlink(os.path.join(reg_dir, name))
            return regs[:cfg.total_clients]
        if time.time() > deadline:
            raise TimeoutError(f"only {len(regs)}/{cfg.total_clients} clients registered")
        time.sleep(0.5)


def _attacks_from_registrations(regs: list[dict]) -> tuple:
    """One attack spec per attacking registration, for client index i (its
    position in the sorted registrations)."""
    from attackfl_tpu_torch.config import AttackSpec

    return tuple(AttackSpec(mode=reg["attack_mode"], client_ids=(i,),
                            attack_round=int(reg["attack_round"] or 1),
                            args=tuple(reg.get("attack_args") or []))
                 for i, reg in enumerate(regs) if reg.get("attack"))


def server_main(argv=None) -> int:
    """The server (JAX cli.py:137-310): every flag of JAX's sets the
    Config field its YAML key sets; the port's engine refuses what it
    cannot run yet, naming the ROADMAP item."""
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch server",
        description="Federated poisoning simulation on one GPU (PyTorch port).")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--no-wait", action="store_true",
                        help="skip the client rendezvous; attackers come from the config")
    parser.add_argument("--rounds", type=int, default=None, help="override num-round")
    # --- round-executor and persistence overrides (the config's server: section) ---
    parser.add_argument("--pipeline", action="store_true",
                        help="depth-k pipelined round executor: round N resolves while "
                             "the next rounds run on the card (server.pipeline)")
    parser.add_argument("--pipeline-depth", type=str, default=None, metavar="K",
                        help="pipeline depth, 0..max or 'auto' (server.pipeline-depth); "
                             "implies --pipeline")
    parser.add_argument("--checkpoint-async", action="store_true",
                        help="background checkpoint writer: serialize, write and fsync "
                             "off the round loop (server.checkpoint-async)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint directory's manifest.json: "
                             "the newest valid entry wins, a torn one falls back to the "
                             "one before, round numbering continues (server.resume)")
    parser.add_argument("--inject-faults", type=str, default=None, metavar="PLAN",
                        help="deterministic fault plan, e.g. 'nan_storm@3:clients=0,1;"
                             "ckpt_write_error@2:count=2;writer_death@4' (kinds: nan_storm "
                             "dropout ckpt_write_error ckpt_torn writer_death monitor_stall; "
                             "the config's `faults:` section takes the same entries as "
                             "mappings)")
    parser.add_argument("--validation-every", type=int, default=None, metavar="K",
                        help="validate every K-th broadcast (server.validation-every; "
                             "default 1)")
    parser.add_argument("--validation-async", action="store_true",
                        help="validate round N while round N+1 trains; the result lands "
                             "in the round's history entry and does not gate the round "
                             "(server.validation-async)")
    parser.add_argument("--compile-cache", type=str, default=None, metavar="DIR",
                        help="compile-cache-dir, accepted for the JAX package's schema; "
                             "the port compiles no programs (its kernels' libraries are "
                             "cached under attackfl_tpu_torch/_build)")
    # --- observability overrides (the config's telemetry: section; ROADMAP.md item 16) ---
    parser.add_argument("--monitor", action="store_true",
                        help="live health endpoint and stall watchdog (telemetry.monitor)")
    parser.add_argument("--monitor-port", type=int, default=None,
                        help="monitor port; implies --monitor (telemetry.monitor-port)")
    parser.add_argument("--profile-rounds", type=str, default=None, metavar="A:B",
                        help="profile rounds A..B (telemetry.profile-rounds)")
    parser.add_argument("--hotspots", type=str, default=None, metavar="A:B",
                        help="hotspot window over rounds A..B (telemetry.hotspots)")
    parser.add_argument("--numerics", action="store_true",
                        help="device-side per-round numerics rows (telemetry.numerics)")
    # --- multi-host scale-out (ROADMAP.md item 14) ---
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 (needs --no-wait)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    args = parser.parse_args(argv)

    if args.coordinator:
        if not args.no_wait:
            # the file rendezvous is host-local: with N hosts the attackers
            # must come from the shared config
            print("Error: --coordinator requires --no-wait "
                  "(declare attackers in config's attack-clients).")
            return 1
        from attackfl_tpu_torch.training.engine import _refuse

        _refuse("multi-host --coordinator", "item 14")

    from attackfl_tpu_torch.config import load_config

    cfg = load_config(args.config)
    overrides: dict = {}
    if args.monitor:
        overrides["monitor"] = True
    if args.monitor_port is not None:
        overrides["monitor"] = True
        overrides["monitor_port"] = args.monitor_port
    if args.profile_rounds is not None:
        overrides["profile_rounds"] = args.profile_rounds
    if args.hotspots is not None:
        overrides["hotspots"] = args.hotspots
    if args.numerics:
        overrides["numerics"] = True
    if overrides:
        cfg = cfg.replace(telemetry=dataclasses.replace(cfg.telemetry, **overrides))
    perf: dict = {}
    if args.pipeline:
        perf["pipeline"] = True
    if args.pipeline_depth is not None:
        perf["pipeline"] = True
        perf["pipeline_depth"] = args.pipeline_depth
    if args.checkpoint_async:
        perf["checkpoint_async"] = True
    if args.resume:
        perf["resume"] = True
    if args.inject_faults is not None:
        from attackfl_tpu_torch.faults.plan import parse_fault_plan

        perf["faults"] = parse_fault_plan(args.inject_faults)
    if args.validation_every is not None:
        perf["validation_every"] = args.validation_every
    if args.validation_async:
        perf["validation_async"] = True
    if args.compile_cache is not None:
        perf["compile_cache_dir"] = args.compile_cache
    if perf:
        cfg = cfg.replace(**perf)

    if not args.no_wait:
        regs = _collect_registrations(cfg, os.path.dirname(os.path.abspath(args.config)))
        print_with_color("All clients are connected. Sending notifications.", "green")
        cfg = cfg.replace(attacks=_attacks_from_registrations(regs))

    from attackfl_tpu_torch.training.engine import Simulator

    sim = Simulator(cfg, device=args.device)
    try:
        _, history = sim.run(num_rounds=args.rounds)
    finally:
        sim.close()
    ok_rounds = sum(1 for h in history if h["ok"])
    print_with_color(f"Finished: {ok_rounds} successful rounds.", "green")
    return 0


def run_main(argv=None) -> int:
    """``run``: the launcher without the rendezvous (JAX cli.py:313-317)."""
    args = list(sys.argv[1:] if argv is None else argv)
    return server_main(["--no-wait", *args])


_SUBCOMMANDS = {"run": run_main, "server": server_main, "client": client_main}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return 0 if args else 2
    command = _SUBCOMMANDS.get(args[0])
    if command is None:
        print(f"unknown command {args[0]!r}\n{_USAGE}", end="", file=sys.stderr)
        return 2
    return command(args[1:])
