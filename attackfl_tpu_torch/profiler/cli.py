"""``python -m attackfl_tpu_torch hotspots``: mine profiler traces,
render, diff, gate (the port's copy of ``attackfl_tpu/profiler/cli.py``).

Torch-free (stdlib + :mod:`attackfl_tpu_torch.profiler.mine` only — safe
on any box that merely holds the trace artifacts):

* ``show [DIR]`` — mine every ``*.trace.json.gz`` under DIR (a
  ``profile/`` tree, or a telemetry dir containing one; default ``.``)
  and render the attribution report: top-K op table, category rollup,
  dispatch-gap histogram, host-bound classification, books-close
  verdict.  Exit 0 on a usable, books-closing report; 1 when no window
  mined OK or the books fail; 2 on usage errors.
* ``diff A B`` — mine two directories and gate the drift with the
  ledger's thresholds (absolute host-bound-fraction rise,
  absolute top-op share drift on ops named in both tables).  Exit 0
  within thresholds (diff-vs-self always passes), 1 on drift, 2 on
  usage/unminable inputs.

Both take ``--json`` for the machine-readable report.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any

from attackfl_tpu_torch.profiler.mine import (
    DEFAULT_TOP_K,
    HOST_BOUND_THRESHOLD,
    mine_profile_dir,
)

# gate defaults shared with `ledger regress` (compare.DEFAULT_THRESHOLDS
# — duplicated as literals so this module imports nothing else)
DEFAULT_HOSTBOUND_RISE = 0.15
DEFAULT_SHARE_DRIFT = 0.15


def _resolve_dir(path: str) -> str:
    """A telemetry dir containing ``profile/`` resolves to it; a profile
    tree (or anything else) is mined as-is."""
    nested = os.path.join(path, "profile")
    return nested if os.path.isdir(nested) else path


def _fmt(value: Any, nd: int = 4) -> str:
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, float):
        return f"{value:.{nd}g}"
    return "-" if value is None else str(value)


def _render(report: dict[str, Any], top_k: int) -> str:
    lines = [
        f"profile dir: {report['dir']}",
        f"traces: {report['traces']} "
        f"(ok={report['ok']} torn={report['torn']} "
        f"empty={report['empty']})",
    ]
    if report["status"] != "ok":
        lines.append(f"status: {report['status']} — nothing to attribute")
        return "\n".join(lines)
    books = report["books"]
    lines += [
        f"wall: {_fmt(report['wall_us'], 6)}us  "
        f"device busy: {_fmt(report['device_busy_us'], 6)}us  "
        f"op self: {_fmt(report['op_self_us'], 6)}us",
        f"books close: {books['close']} "
        "(op self <= busy <= wall x lanes)",
        f"host-bound fraction: {_fmt(report['host_bound_fraction'])} "
        f"-> {report['classification']} "
        f"(threshold {HOST_BOUND_THRESHOLD})",
    ]
    lines.append(f"{'op':<40}{'category':<13}{'self us':>12}"
                 f"{'share':>8}{'n':>6}  program")
    for row in report["ops"][:top_k]:
        lines.append(
            f"{row['name'][:39]:<40}{row['category']:<13}"
            f"{row['self_us']:>12.1f}{row['share']:>8.3f}"
            f"{row['count']:>6}  {row['program']}")
    lines.append("categories: " + "  ".join(
        f"{name}={_fmt(bucket['share'])}"
        for name, bucket in sorted(
            report["categories"].items(),
            key=lambda kv: -kv[1]["self_us"])))
    if report["gap_histogram"]:
        cells = []
        for bucket in report["gap_histogram"]:
            label = ("inf" if bucket["le_us"] is None
                     else f"{bucket['le_us']:g}us")
            cells.append(f"<={label}:{bucket['count']}")
        lines.append("dispatch gaps: " + "  ".join(cells))
    for window in report["windows"]:
        if window["status"] != "ok":
            lines.append(
                f"window {window['trace']}: {window['status']} "
                "(counted, not attributed)")
    return "\n".join(lines)


def _cmd_show(args: list[str]) -> int:
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    top_k = DEFAULT_TOP_K
    if "--top" in args:
        at = args.index("--top")
        if at + 1 >= len(args):
            print("--top needs a value", file=sys.stderr)
            return 2
        try:
            top_k = int(args[at + 1])
        except ValueError:
            print(f"--top needs an integer, got {args[at + 1]!r}",
                  file=sys.stderr)
            return 2
        del args[at:at + 2]
    if len(args) > 1:
        print("usage: python -m attackfl_tpu_torch hotspots show [DIR] [--json] [--top K]",
              file=sys.stderr)
        return 2
    path = _resolve_dir(args[0] if args else ".")
    report = mine_profile_dir(path, top_k=top_k)
    if as_json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(_render(report, top_k))
    if report["status"] != "ok" or not report["books"]["close"]:
        return 1
    return 0


def _shares(report: dict[str, Any]) -> dict[str, float]:
    return {row["name"]: row["share"] for row in report["top_ops"]}


def _cmd_diff(args: list[str]) -> int:
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    hostbound_rise = DEFAULT_HOSTBOUND_RISE
    share_drift = DEFAULT_SHARE_DRIFT
    for flag in ("--hostbound-rise", "--share-drift"):
        if flag in args:
            at = args.index(flag)
            if at + 1 >= len(args):
                print(f"{flag} needs a value", file=sys.stderr)
                return 2
            try:
                value = json.loads(args[at + 1])
            except ValueError:
                value = None
            if isinstance(value, bool) or \
                    not isinstance(value, (int, float)):
                print(f"{flag} needs a number, got {args[at + 1]!r}",
                      file=sys.stderr)
                return 2
            if flag == "--hostbound-rise":
                hostbound_rise = value + 0.0
            else:
                share_drift = value + 0.0
            del args[at:at + 2]
    if len(args) != 2:
        print("usage: python -m attackfl_tpu_torch hotspots diff A B [--json]\n"
              "  [--hostbound-rise X] [--share-drift X]",
              file=sys.stderr)
        return 2
    old = mine_profile_dir(_resolve_dir(args[0]))
    new = mine_profile_dir(_resolve_dir(args[1]))
    if old["status"] != "ok" or new["status"] != "ok":
        print(f"cannot diff: {args[0]} status={old['status']}, "
              f"{args[1]} status={new['status']}", file=sys.stderr)
        return 2
    old_hb = old["host_bound_fraction"] or 0.0
    new_hb = new["host_bound_fraction"] or 0.0
    violations: list[dict[str, Any]] = []
    if (new_hb - old_hb) > hostbound_rise:
        violations.append({
            "check": "host_bound_fraction",
            "old": old_hb, "new": new_hb,
            "rise": round(new_hb - old_hb, 4),
            "threshold": hostbound_rise})
    old_shares, new_shares = _shares(old), _shares(new)
    drifts = {}
    for name in sorted(set(old_shares) & set(new_shares)):
        drift = round(new_shares[name] - old_shares[name], 4)
        drifts[name] = {"old": old_shares[name],
                        "new": new_shares[name], "drift": drift}
        if abs(drift) > share_drift:
            violations.append({
                "check": f"op_share:{name}",
                "old": old_shares[name], "new": new_shares[name],
                "drift": drift, "threshold": share_drift})
    result = {
        "ok": not violations,
        "violations": violations,
        "host_bound_fraction": {"old": old_hb, "new": new_hb},
        "op_shares": drifts,
        "old_dir": old["dir"], "new_dir": new["dir"],
    }
    if as_json:
        print(json.dumps(result, indent=1, sort_keys=True))
    else:
        print(f"hostbound: {_fmt(old_hb)} -> {_fmt(new_hb)} "
              f"(rise threshold {hostbound_rise})")
        for name, row in drifts.items():
            print(f"  {name}: share {_fmt(row['old'])} -> "
                  f"{_fmt(row['new'])} (drift {_fmt(row['drift'])})")
        if violations:
            for violation in violations:
                moved = violation.get("rise", violation.get("drift"))
                print(f"DRIFT {violation['check']}: {_fmt(moved)} "
                      f"past {_fmt(violation['threshold'])}")
        else:
            print("ok: within thresholds")
    return 0 if not violations else 1


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__, end="")
        return 0 if args else 2
    command = args[0]
    if command == "show":
        return _cmd_show(args[1:])
    if command == "diff":
        return _cmd_diff(args[1:])
    print(f"unknown hotspots subcommand {command!r} "
          "(expected show|diff)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
