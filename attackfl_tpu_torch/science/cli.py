"""``python -m attackfl_tpu_torch science``: leaderboards, scoreboard
reports, rank gates (the port's copy of ``attackfl_tpu/science/cli.py``;
its output and exit codes are the JAX package's).

Subcommands (torch-free, like the ledger CLI — they read the ledger's JSON
and print):

* ``leaderboard`` — defense robustness leaderboard + attack
  effectiveness for one sweep (default: the newest sweep in the ledger);
  ``--outcomes`` prints the per-cell outcome table instead;
* ``report`` — the full scoreboard document (leaderboard + outcome rows
  + provenance) to stdout or ``--out SCOREBOARD.json``;
* ``diff OLD NEW`` — rank stability between two sweeps (Kendall tau,
  per-defense rank/damage deltas with their inter-seed noise floor);
  ``--gate`` turns it into the CI hook: exit 1 when a defense's rank
  flips or its damage regresses beyond the noise floor, exit 2 when
  there is nothing to compare, exit 0 otherwise.  With no positional
  sweeps, the two newest sweeps in the ledger are compared.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir
from attackfl_tpu_torch.science.outcomes import (
    format_outcomes, outcome_rows, sweep_ids,
)
from attackfl_tpu_torch.science.rank import (
    DEFAULT_BOOTSTRAP, format_diff, format_leaderboard, leaderboard,
    rank_diff,
)

SCOREBOARD_VERSION = 1


def _load_records(args) -> list[dict[str, Any]]:
    directory = args.dir or resolve_ledger_dir()
    store = LedgerStore(directory)
    records, _ = store.load()
    return records


def _resolve_sweep(records: list[dict[str, Any]], wanted: str | None,
                   offset_from_end: int = 1) -> str | None:
    """Resolve a sweep id: an explicit id (prefix ok when unambiguous),
    ``latest``/None -> the newest, with ``offset_from_end`` counting back
    from the end for default diff pairs."""
    ids = sweep_ids(records)
    if not ids:
        return None
    if wanted in (None, "latest"):
        return ids[-offset_from_end] if len(ids) >= offset_from_end \
            else None
    if wanted in ids:
        return wanted
    matches = [s for s in ids if s.startswith(wanted)]
    return matches[0] if len(matches) == 1 else None


def build_report(records: list[dict[str, Any]], sweep_id: str,
                 n_boot: int = DEFAULT_BOOTSTRAP,
                 boot_seed: int = 0) -> dict[str, Any]:
    """The SCOREBOARD.json document: leaderboard + the outcome rows it
    was computed from (committed alongside so the ranking is auditable
    without the ledger)."""
    rows = outcome_rows(records, sweep_id=sweep_id)
    board = leaderboard(rows, sweep_id=sweep_id, n_boot=n_boot,
                        boot_seed=boot_seed)
    return {
        "scoreboard_version": SCOREBOARD_VERSION,
        "bootstrap": {"n": n_boot, "seed": boot_seed},
        **board,
        "outcomes": rows,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch science",
        description="Attack-defense leaderboards, damage attribution and "
                    "rank-stability gates over matrix-sweep ledger "
                    "records.")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dir", type=str, default=None,
                        help="ledger directory (default: "
                             "$ATTACKFL_LEDGER_DIR or ./ledger)")
    common.add_argument("--bootstrap", type=int, default=DEFAULT_BOOTSTRAP,
                        help="bootstrap resamples for the CI (default "
                             f"{DEFAULT_BOOTSTRAP})")
    common.add_argument("--boot-seed", type=int, default=0,
                        help="bootstrap PRNG seed (deterministic CIs)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_board = sub.add_parser(
        "leaderboard", parents=[common],
        help="defense robustness leaderboard for one sweep")
    p_board.add_argument("--sweep-id", type=str, default=None,
                         help="sweep to rank (default: newest; prefixes "
                              "resolve when unambiguous)")
    p_board.add_argument("--outcomes", action="store_true",
                         help="print the per-cell outcome table instead")
    p_board.add_argument("--json", action="store_true")

    p_rep = sub.add_parser(
        "report", parents=[common],
        help="full scoreboard document (leaderboard + outcome rows)")
    p_rep.add_argument("--sweep-id", type=str, default=None)
    p_rep.add_argument("--out", type=str, default=None,
                       help="write the JSON document here (e.g. "
                            "SCOREBOARD.json) instead of stdout")

    p_diff = sub.add_parser(
        "diff", parents=[common],
        help="rank stability between two sweeps; --gate exits 1 on a "
             "regression")
    p_diff.add_argument("old", nargs="?", default=None,
                        help="baseline sweep id (default: second-newest)")
    p_diff.add_argument("new", nargs="?", default=None,
                        help="candidate sweep id (default: newest)")
    p_diff.add_argument("--gate", action="store_true",
                        help="CI mode: exit 1 on rank flip / damage "
                             "regression beyond the noise floor")
    p_diff.add_argument("--damage-floor", type=float, default=0.0,
                        help="minimum damage delta that can ever fail "
                             "the gate (added under the measured "
                             "inter-seed noise floor)")
    p_diff.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    records = _load_records(args)
    if not sweep_ids(records):
        print("no matrix-sweep records in "
              f"{args.dir or resolve_ledger_dir()!r}", file=sys.stderr)
        return 2

    if args.command == "leaderboard":
        sweep = _resolve_sweep(records, args.sweep_id)
        if sweep is None:
            print(f"no sweep matching {args.sweep_id!r}", file=sys.stderr)
            return 2
        rows = outcome_rows(records, sweep_id=sweep)
        if args.outcomes:
            print(json.dumps(rows, indent=1) if args.json
                  else format_outcomes(rows))
            return 0
        board = leaderboard(rows, sweep_id=sweep, n_boot=args.bootstrap,
                            boot_seed=args.boot_seed)
        print(json.dumps(board, indent=1) if args.json
              else format_leaderboard(board))
        return 0

    if args.command == "report":
        sweep = _resolve_sweep(records, args.sweep_id)
        if sweep is None:
            print(f"no sweep matching {args.sweep_id!r}", file=sys.stderr)
            return 2
        report = build_report(records, sweep, n_boot=args.bootstrap,
                              boot_seed=args.boot_seed)
        text = json.dumps(report, indent=1)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
            print(f"wrote scoreboard for sweep {sweep} "
                  f"({report['defenses']} defenses x "
                  f"{report['attacks']} attacks x {report['seeds']} "
                  f"seeds) to {args.out}")
        else:
            print(text)
        return 0

    if args.command == "diff":
        ids = sweep_ids(records)
        old_id = _resolve_sweep(records, args.old, offset_from_end=2)
        new_id = _resolve_sweep(records, args.new, offset_from_end=1)
        if old_id is None or new_id is None:
            which = args.old if old_id is None and args.old else args.new
            if which:
                print(f"no sweep matching {which!r} (known: "
                      f"{', '.join(ids)})", file=sys.stderr)
            else:
                print(f"need two sweeps to diff; ledger has "
                      f"{len(ids)}", file=sys.stderr)
            return 2
        boards = [
            leaderboard(outcome_rows(records, sweep_id=sid),
                        sweep_id=sid, n_boot=args.bootstrap,
                        boot_seed=args.boot_seed)
            for sid in (old_id, new_id)]
        diff = rank_diff(boards[0], boards[1],
                         damage_floor=args.damage_floor)
        print(json.dumps(diff, indent=1) if args.json
              else format_diff(diff))
        if not diff["common_defenses"]:
            print("no common defenses between the sweeps — nothing to "
                  "gate", file=sys.stderr)
            return 2
        if args.gate and not diff["ok"]:
            return 1
        return 0

    raise AssertionError(f"unhandled command {args.command!r}")


if __name__ == "__main__":
    raise SystemExit(main())
