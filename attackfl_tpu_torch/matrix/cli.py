"""``python -m attackfl_tpu_torch matrix run|status``: the sweep front
door (the port's ``attackfl_tpu/matrix/cli.py``).

``run`` reads the grid from the config's ``matrix:`` section (see
:func:`attackfl_tpu_torch.matrix.grid.grid_from_dict` for the format),
lets flags override each axis, and runs the whole (attack × defense ×
seed) grid on one device
(:class:`attackfl_tpu_torch.training.matrix_exec.MatrixRun`); ``--device``
defaults to ``cuda``, as every entry point's.  ``--mesh`` splits the
sweep's cell axis over a client mesh of the visible devices
(``tpu.num-devices``), as JAX's.  ``status`` is torch-free: it
reads the sweep's ledger records (all sharing a ``sweep_id``) and renders
the grid's completion and quality table.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from attackfl_tpu_torch.telemetry.console import print_with_color


def _parse_list(text: str) -> list[str]:
    return [item.strip() for item in text.split(",") if item.strip()]


def run_main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch matrix run",
        description="Run a full (attack x defense x seed) sweep on one device.")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--attacks", type=str, default=None,
                        help="comma list of attack modes (overrides the config's "
                             "matrix.attacks)")
    parser.add_argument("--defenses", type=str, default=None,
                        help="comma list of defense modes")
    parser.add_argument("--seeds", type=str, default=None, help="comma list of seeds")
    parser.add_argument("--rounds", type=int, default=None)
    parser.add_argument("--chunk", type=int, default=None,
                        help="rounds per chunk (one read of the card)")
    parser.add_argument("--sweep-dir", type=str, default=None,
                        help="sweep working directory (telemetry + checkpoints + "
                             "per-cell fallback dirs; default: the config's log_path)")
    parser.add_argument("--sweep-id", type=str, default=None,
                        help="explicit sweep id (default: random)")
    parser.add_argument("--resume", action="store_true",
                        help="continue an interrupted sweep from its newest valid "
                             "checkpoint (byte-identical grid)")
    parser.add_argument("--mesh", action="store_true",
                        help="shard the sweep's cell axis over the device mesh "
                             "(tpu.num-devices)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import yaml

    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.matrix.grid import grid_from_dict

    cfg = load_config(args.config)
    with open(args.config) as fh:
        raw = yaml.safe_load(fh) or {}
    grid_raw = dict(raw.get("matrix") or {})
    if args.attacks:
        grid_raw["attacks"] = _parse_list(args.attacks)
    if args.defenses:
        grid_raw["defenses"] = _parse_list(args.defenses)
    if args.seeds:
        grid_raw["seeds"] = [int(s) for s in _parse_list(args.seeds)]
    if args.rounds is not None:
        grid_raw["rounds"] = args.rounds
    if args.chunk is not None:
        grid_raw["chunk"] = args.chunk
    grid = grid_from_dict(grid_raw)

    overrides: dict[str, Any] = {}
    if args.sweep_dir:
        overrides["log_path"] = args.sweep_dir
        overrides["checkpoint_dir"] = args.sweep_dir
    if args.resume:
        overrides["resume"] = True
    if cfg.prng_impl != "threefry2x32":
        # the JAX package's batched grid needs vmap-invariant keys
        # (grid.validate_base), and the same YAML runs in both packages
        print_with_color(
            f"[matrix] prng_impl {cfg.prng_impl!r} is not vmap-invariant; "
            "forcing threefry2x32 for this sweep", "yellow")
        overrides["prng_impl"] = "threefry2x32"
    if overrides:
        cfg = cfg.replace(**overrides)

    from attackfl_tpu_torch.training.matrix_exec import MatrixRun

    runner = MatrixRun(cfg, grid, sweep_id=args.sweep_id, device=args.device,
                       use_mesh=args.mesh)
    print_with_color(
        f"[matrix] sweep {runner.sweep_id}: {grid.n_cells} cells "
        f"({len(runner.device_cells)} in the folded grid, "
        f"{len(runner.fallback_cells)} per-cell fallback)", "cyan")
    try:
        final_params, histories = runner.run()
    finally:
        if runner.telemetry.enabled:
            print_with_color(
                f"Telemetry: {runner.telemetry.events.path} — per-cell records: "
                f"`python -m attackfl_tpu_torch matrix status --sweep-id "
                f"{runner.sweep_id}`", "cyan")
        runner.close()
    ok_cells = sum(1 for h in histories.values()
                   if sum(1 for e in h if e.get("ok")) >= grid.rounds)
    print_with_color(
        f"[matrix] sweep {runner.sweep_id} finished: {len(histories)}/{grid.n_cells} cells "
        f"ran, {ok_cells} completed all {grid.rounds} rounds", "green")
    return 0


def status_main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch matrix status",
        description="Render a sweep's per-cell ledger records as a grid table "
                    "(torch-free).")
    parser.add_argument("--dir", type=str, default=None,
                        help="ledger directory (default: $ATTACKFL_LEDGER_DIR or ./ledger)")
    parser.add_argument("--sweep-id", type=str, default=None,
                        help="sweep to show (default: the newest)")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir

    store = LedgerStore(args.dir or resolve_ledger_dir())
    records, _ = store.load()
    cells = [r for r in records if r.get("source") == "matrix" and r.get("sweep_id")]
    if not cells:
        print(f"no matrix records in {store.directory!r}", file=sys.stderr)
        return 2
    sweep_id = args.sweep_id or cells[-1]["sweep_id"]
    cells = [r for r in cells if r.get("sweep_id") == sweep_id]
    if not cells:
        print(f"no records for sweep {sweep_id!r}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(cells, indent=1))
        return 0
    # the science join supplies the quality/damage columns: damage = the
    # cell's `none`-baseline quality minus its own
    from attackfl_tpu_torch.science.outcomes import outcome_rows

    joined = {row["cell"]: row for row in outcome_rows(cells, sweep_id=sweep_id)}
    print(f"sweep {sweep_id}: {len(cells)} cell record(s)")
    print(f"{'cell':<30}{'rounds':>8}{'ok':>5}{'roc_auc':>9}"
          f"{'accuracy':>10}{'loss':>9}{'quality':>9}{'damage':>9}")
    for record in cells:
        final = record.get("final") or {}
        row = joined.get(record.get("cell")) or {}

        def fmt(value) -> str:
            return (f"{value:.4f}" if isinstance(value, (int, float))
                    and not isinstance(value, bool) else "-")

        print(f"{str(record.get('cell'))[:29]:<30}"
              f"{record.get('rounds', 0):>8}"
              f"{record.get('ok_rounds', 0):>5}"
              f"{fmt(final.get('roc_auc')):>9}"
              f"{fmt(final.get('accuracy')):>10}"
              f"{fmt(final.get('train_loss')):>9}"
              f"{fmt(row.get('quality')):>9}"
              f"{fmt(row.get('damage')):>9}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print("usage: python -m attackfl_tpu_torch matrix run|status [args]\n"
              "  run     execute a sweep (grid from the config's matrix: section + flag "
              "overrides)\n"
              "  status  per-cell completion/quality table from the sweep's ledger "
              "records")
        return 0 if args else 2
    if args[0] == "run":
        return run_main(args[1:])
    if args[0] == "status":
        return status_main(args[1:])
    print(f"unknown matrix command {args[0]!r}", file=sys.stderr)
    return 2
