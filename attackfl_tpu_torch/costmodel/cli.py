"""``python -m attackfl_tpu_torch cost estimate|validate``: the predictive
front door (the port's copy of ``attackfl_tpu/costmodel/cli.py``).

``estimate`` prices a config WITHOUT running it: fingerprint-peer ledger
records first (their median measured ``round_device_time``), a
flops/bytes regression over non-peer records when the config is new.
The no-peer path needs the candidate's profile, which means counting its
synchronous round programs on fake tensors (``FakeTensorMode``: shapes
only, no round runs, no state advances, nothing is read from the card);
``--no-compile`` suppresses that and reports the config as unpredictable
instead.  A program that reads a value from its tensors (the γ-search
attacks, hyper mode's update) cannot be counted without running and is
left out of the profile, as JAX leaves out a program whose compile
raises; with none counted the config is unpredictable.  ``--matrix``
prices the config's ``matrix:`` grid cell by cell, as JAX's does: each
cell's standalone config by its peers, the first peerless cell's counted
profile standing for its siblings, and the sum as the sweep's serial
bound.

``validate`` is the accuracy contract: leave-one-out replay of the
predictor over a ledger corpus, exit 1 when the median symmetric error
factor exceeds ``--max-median-factor`` (default 2x), exit 2 when the
corpus has nothing measurable.  Torch-free.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any

from attackfl_tpu_torch.costmodel.estimate import (
    DEFAULT_MAX_MEDIAN_FACTOR, predict_run, validate_predictions,
)


def _load_records(directory: str | None) -> tuple[list[dict[str, Any]], str]:
    from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir

    resolved = directory or resolve_ledger_dir()
    store = LedgerStore(resolved)
    records, _ = store.load()
    return records, resolved


def sync_programs(sim, state: dict[str, Any]) -> list[tuple[str, Any, tuple]]:
    """The synchronous round's programs with their arguments, ``(name,
    fn, args)`` each, as the engine dispatches them (JAX
    ``sync_profile_programs``, engine.py:780-809): ``round_step`` (the
    round's draws and its round step), then ``aggregate`` or, in hyper
    mode, ``hyper_update``; a later program's arguments come from the
    round step's outputs, so ``args`` of those are callables of them."""
    import torch

    b = 1
    if sim.is_hyper:
        active = state["active_mask"].to(sim.device)
        step = ("round_step", sim._drawn_round_step,
                (state["hnet_params"], state["prev_genuine"], state["have_genuine"],
                 state["rng"], b, active, None))
        later = ("hyper_update", sim.hyper_update,
                 lambda draws, out: (state["hnet_params"], state["hyper_opt_state"], out[0],
                                     active * (out[1] > 0)))
    else:
        step = ("round_step", sim._drawn_round_step,
                (state["global_params"], state["prev_genuine"], state["have_genuine"],
                 state["rng"], b))
        later = ("aggregate", sim.aggregate,
                 lambda draws, out: (state["global_params"], out[0], out[1],
                                     torch.ones(sim.cfg.total_clients, device=sim.device)
                                     * (out[1] > 0), draws))
    return [step, later]


def count_sync_programs(cfg, device: str = "cuda") -> dict[str, dict[str, Any]]:
    """Count the config's synchronous round programs on fake tensors
    (telemetry off, nothing runs): ``{name: profile}``, each profile
    ``count_program``'s.  A program that reads a value is left out, and
    with it the programs that take its outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from attackfl_tpu_torch.costmodel.capture import count_program
    from attackfl_tpu_torch.training.engine import Simulator

    quiet = cfg.replace(telemetry=dataclasses.replace(cfg.telemetry, enabled=False,
                                                      monitor=False))
    sim = Simulator(quiet, device=device)
    programs: dict[str, dict[str, Any]] = {}
    try:
        state = sim.init_state()
        (name, fn, args), (later_name, later_fn, later_args) = sync_programs(sim, state)
        with FakeTensorMode(allow_non_fake_inputs=True):
            try:
                (draws, out), programs[name] = count_program(fn, *args)
                _, programs[later_name] = count_program(later_fn, *later_args(draws, out))
            except Exception:  # noqa: BLE001 — a value read: left out, as JAX
                pass
    finally:
        sim.close()
    return programs


def profile_config(cfg, device: str = "cuda") -> dict[str, Any] | None:
    """The config's per-round cost profile from
    :func:`count_sync_programs` — the regression fallback's input; None
    when no program was counted."""
    from attackfl_tpu_torch.costmodel.roofline import per_round_cost

    programs = count_sync_programs(cfg, device)
    return per_round_cost({name: dict(p, rounds_per_dispatch=1)
                           for name, p in programs.items()})


def _estimate_one(records, fingerprint: str, rounds: int,
                  cfg, compile_ok: bool, device: str = "cuda") -> dict[str, Any]:
    prediction = predict_run(records, fingerprint, rounds)
    reason = None
    if prediction is None:
        reason = "no fingerprint peer in the ledger"
        profile = profile_config(cfg, device) if compile_ok and cfg is not None else None
        if profile is None:
            reason += (", and no profile (--no-compile)" if not compile_ok else
                       ", and no profile (its round step reads a value, so it is not "
                       "counted without a run)")
        else:
            prediction = predict_run(records, fingerprint, rounds, profile=profile)
            if prediction is not None:
                prediction["profile"] = {
                    k: profile.get(k)
                    for k in ("flops_per_round", "bytes_per_round")}
            else:
                reason += ", and no measured record with a profile to regress on"
    if prediction is None:
        return {"fingerprint": fingerprint, "rounds": rounds,
                "method": "unpredictable", "reason": reason}
    return {"fingerprint": fingerprint, **prediction}


def estimate_main(args) -> int:
    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

    cfg = load_config(args.config)
    if args.rounds is not None:
        cfg = cfg.replace(num_round=args.rounds)
    records, directory = _load_records(args.dir)
    out: dict[str, Any] = {"ledger": directory,
                           "ledger_records": len(records)}

    if args.matrix:
        import yaml

        from attackfl_tpu_torch.matrix.grid import cell_config, expand_cells, grid_from_dict

        with open(args.config) as fh:
            raw = yaml.safe_load(fh) or {}
        grid = grid_from_dict(dict(raw.get("matrix") or {}))
        per_cell = []
        total = 0.0
        predictable = 0
        for cell in expand_cells(grid):
            ccfg = cell_config(cfg, cell, rounds=grid.rounds)
            estimate = _estimate_one(
                records, config_fingerprint(ccfg), grid.rounds,
                # the cells share the round's shapes, so the FIRST peerless
                # cell's profile prices its siblings too (flops differ only
                # by the defense, second-order)
                ccfg if predictable == 0 else None, not args.no_compile, args.device)
            estimate["cell"] = cell.key
            per_cell.append(estimate)
            wall = estimate.get("predicted_wall_seconds")
            if wall is not None:
                total += wall
                predictable += 1
        out.update({
            "grid": grid.describe(),
            "cells": per_cell,
            "predictable_cells": predictable,
            # serial bound: the sweep folds its device cells' training, so
            # the real sweep lands at or under this
            "predicted_sweep_wall_seconds_serial_bound": round(total, 3),
        })
    else:
        estimate = _estimate_one(records, config_fingerprint(cfg), cfg.num_round, cfg,
                                 not args.no_compile, args.device)
        out.update(estimate)

    if args.json:
        print(json.dumps(out, indent=1))
    else:
        print(format_estimate(out))
    return 0 if out.get("method") != "unpredictable" else 2


def format_estimate(out: dict[str, Any]) -> str:
    lines = [f"cost estimate — ledger {out['ledger']} "
             f"({out['ledger_records']} record(s))"]
    if "cells" in out:
        lines.append(
            f"matrix grid: {out['grid']['n_cells']} cells x "
            f"{out['grid']['rounds']} rounds")
        for cell in out["cells"]:
            wall = cell.get("predicted_wall_seconds")
            lines.append(
                f"  {cell['cell']:<32} "
                + (f"{wall:>9.2f}s  [{cell.get('method')}]"
                   if wall is not None else "unpredictable "
                   "(no peer, no profile)"))
        lines.append(
            f"predicted sweep wall (serial bound): "
            f"{out['predicted_sweep_wall_seconds_serial_bound']}s over "
            f"{out['predictable_cells']} predictable cell(s)")
        return "\n".join(lines)
    if out.get("method") == "unpredictable":
        lines.append(f"unpredictable: {out['reason']} (run once with "
                     "telemetry.ledger on, or drop --no-compile)")
        return "\n".join(lines)
    lines.append(
        f"method: {out['method']}"
        + (f" over {out['peers']} peer record(s)" if "peers" in out else "")
        + (f" fit on {out['fit_records']} record(s)"
           if "fit_records" in out else ""))
    lines.append(
        f"per-round: device={out['round_device_time']}s"
        + (f" host={out['host_resolution_latency']}s"
           if out.get("host_resolution_latency") is not None
           else " (device-only: no host-latency peer)"))
    lines.append(f"predicted wall for {out['rounds']} round(s): "
                 f"{out['predicted_wall_seconds']}s")
    return "\n".join(lines)


def validate_main(args) -> int:
    records, directory = _load_records(args.dir)
    report = validate_predictions(records, window=args.window)
    report["ledger"] = directory
    ok = (report["predicted"] > 0
          and report["median_error_factor"] is not None
          and report["median_error_factor"] <= args.max_median_factor)
    if args.json:
        print(json.dumps({**report, "ok": ok,
                          "max_median_factor": args.max_median_factor},
                         indent=1))
    else:
        lines = [f"cost validate — ledger {directory}: "
                 f"{report['predicted']}/{report['records']} record(s) "
                 f"predicted leave-one-out "
                 f"({report['unpredictable']} unpredictable)"]
        if report["median_error_factor"] is not None:
            lines.append(
                f"error factor: median={report['median_error_factor']}x "
                f"p90={report['p90_error_factor']}x "
                f"worst={report['worst_error_factor']}x "
                f"(bound {args.max_median_factor}x: "
                + ("PASS" if ok else "FAIL") + ")")
        by_method = ", ".join(f"{k}={v}" for k, v in
                              sorted(report["by_method"].items()))
        if by_method:
            lines.append(f"paths: {by_method}")
        for row in report["rows"]:
            predicted = row.get("predicted_s")
            lines.append(
                f"  {str(row.get('record_id'))[:28]:<29}"
                f"measured={row['measured_s']:<10} "
                + (f"predicted={predicted:<10} "
                   f"x{row['error_factor']} [{row['method']}]"
                   if predicted is not None else "[unpredictable]"))
        print("\n".join(lines))
    if report["predicted"] == 0:
        print("nothing to validate: no record carries a measured "
              "round_device_time", file=sys.stderr)
        return 2
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch cost",
        description="Predictive cost model over the cross-run ledger: "
                    "estimate a config or matrix grid without running "
                    "it; validate the predictor against a ledger corpus.")
    sub = parser.add_subparsers(dest="command", required=True)

    p_est = sub.add_parser("estimate",
                           help="predict per-round device time and wall "
                                "time for a config (or --matrix grid)")
    p_est.add_argument("--config", type=str, default="config.yaml")
    p_est.add_argument("--rounds", type=int, default=None,
                       help="override num-round for the wall prediction")
    p_est.add_argument("--matrix", action="store_true",
                       help="price the config's matrix grid per cell")
    p_est.add_argument("--device", type=str, default="cuda",
                       help="device of the count without a run: cuda (default) "
                            "or cpu")
    p_est.add_argument("--dir", type=str, default=None,
                       help="ledger directory (default: "
                            "$ATTACKFL_LEDGER_DIR or ./ledger)")
    p_est.add_argument("--no-compile", action="store_true",
                       help="never count the programs for a profile; "
                            "peerless configs report as unpredictable")
    p_est.add_argument("--json", action="store_true")

    p_val = sub.add_parser("validate",
                           help="leave-one-out accuracy replay over a "
                                "ledger corpus (exit 1 past the bound)")
    p_val.add_argument("--dir", type=str, default=None)
    p_val.add_argument("--window", type=int, default=5,
                       help="peer-median window (records)")
    p_val.add_argument("--max-median-factor", type=float,
                       default=DEFAULT_MAX_MEDIAN_FACTOR,
                       help="median error-factor bound (default 2.0)")
    p_val.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    if args.command == "estimate":
        return estimate_main(args)
    if args.command == "validate":
        return validate_main(args)
    raise AssertionError(f"unhandled command {args.command!r}")


if __name__ == "__main__":
    raise SystemExit(main())
