"""``python -m attackfl_tpu_torch run``: the port's launcher, mirroring
``python -m attackfl_tpu run`` (attackers come from the config's
``attack-clients`` section)."""

from __future__ import annotations

import argparse
import sys

_USAGE = """usage: python -m attackfl_tpu_torch <command> [options]

commands:
  run      run a simulation from a reference-schema config.yaml
           (--config PATH, --device cuda|cpu, --rounds N, --resume)
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
    args = parser.parse_args(argv)

    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.training.engine import Simulator

    cfg = load_config(args.config)
    if args.resume:
        cfg = cfg.replace(resume=True)
    sim = Simulator(cfg, device=args.device)
    _, history = sim.run(num_rounds=args.rounds)
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
