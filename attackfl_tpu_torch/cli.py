"""``python -m attackfl_tpu_torch run``: the port's launcher, mirroring
``python -m attackfl_tpu run`` (attackers come from the config's
``attack-clients`` section)."""

from __future__ import annotations

import argparse
import sys

_USAGE = """usage: python -m attackfl_tpu_torch <command> [options]

commands:
  run      run a simulation from a reference-schema config.yaml
           (--config PATH, --device cuda|cpu, --rounds N, --resume,
           --checkpoint-async, --inject-faults PLAN, --validation-every K,
           --validation-async)
"""


def run_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch run",
        description="Federated poisoning simulation on one GPU (PyTorch port).")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--rounds", type=int, default=None, help="override num-round")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint directory's manifest.json: "
                             "the newest valid entry wins, a torn one falls back to the "
                             "one before, round numbering continues (server.resume)")
    parser.add_argument("--checkpoint-async", action="store_true",
                        help="background checkpoint writer: serialize, write and fsync "
                             "off the round loop (server.checkpoint-async)")
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
    args = parser.parse_args(argv)

    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.faults.plan import parse_fault_plan
    from attackfl_tpu_torch.training.engine import Simulator

    cfg = load_config(args.config)
    overrides: dict = {}
    if args.resume:
        overrides["resume"] = True
    if args.checkpoint_async:
        overrides["checkpoint_async"] = True
    if args.inject_faults is not None:
        overrides["faults"] = parse_fault_plan(args.inject_faults)
    if args.validation_every is not None:
        overrides["validation_every"] = args.validation_every
    if args.validation_async:
        overrides["validation_async"] = True
    if overrides:
        cfg = cfg.replace(**overrides)
    sim = Simulator(cfg, device=args.device)
    try:
        _, history = sim.run(num_rounds=args.rounds)
    finally:
        sim.close()
    ok_rounds = sum(1 for h in history if h["ok"])
    print(f"Finished: {ok_rounds} successful rounds.")
    return 0


_SUBCOMMANDS = {"run": run_main}


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
