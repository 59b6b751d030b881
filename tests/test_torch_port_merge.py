"""The port's event merge (``attackfl_tpu_torch/telemetry/merge.py``) and
``metrics --merge`` against the JAX package's, on the same files.

The inputs: the committed two-process corpus ``tests/data/multihost``
(JAX's exact skew figures), two per-process streams with attribution
events, a synthetic service spool (a service stream and two jobs'
streams, one defended), the committed ``tests/data/events.v12.jsonl`` as
a single-process run directory, and the error paths (no stream, a stream
with no timestamps, a torn line).  On each, the merge functions equal
JAX's and ``metrics --merge`` (text, ``--json``, ``--forensics``,
``--numerics``, ``--programs``) gives JAX's stdout, stderr and exit code.
"""

import json
import pathlib
import shutil

import pytest

from attackfl_tpu.telemetry import merge as jmerge
from attackfl_tpu.telemetry import summary as jsummary
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.telemetry import merge

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _ev(kind, ts, **fields):
    return dict({"schema": 12, "kind": kind, "ts": ts}, **fields)


def _write_jsonl(path, events, tail: str = "") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        for event in events:
            fh.write(json.dumps(event) + "\n")
        fh.write(tail)


def _multihost(root) -> str:
    return str(DATA / "multihost")


def _processes(root) -> str:
    """Two processes of one run: headers, two rounds with phases, and the
    same attribution verdict from both (it dedupes to one)."""
    run = root / "processes"
    for pid in (0, 1):
        events = [_ev("run_header", 10.0 + 0.01 * pid, run_id="shared02", process_index=pid,
                      backend="cpu", num_devices=8, mode="krum", model="CNNModel",
                      data_name="ICU", total_clients=4)]
        for rnd in (1, 2):
            events.append(_ev("round", 10.0 + rnd + 0.05 * pid, run_id="shared02",
                              process_index=pid, round=rnd, broadcast=rnd, ok=True,
                              seconds=0.2 + 0.01 * pid,
                              phases={"train": 0.15 + 0.02 * pid, "aggregate": 0.01}))
        events.append(_ev("attribution", 11.5 + 0.01 * pid, run_id="shared02",
                          process_index=pid, round=1, broadcast=1, mode="krum",
                          attackers=[3], kept=[0], removed=[1, 2, 3]))
        _write_jsonl(run / f"events.{pid}.jsonl", events)
    return str(run)


def _spool(root) -> str:
    """A service stream and two jobs' streams, one of them median-defended
    with attribution events (the per-defense forensics breakdown)."""
    spool = root / "spool"
    _write_jsonl(spool / "service.events.jsonl", [
        _ev("service", 0.0, action="started", slots=1, starvation_bound_seconds=100.0),
        _ev("job", 1.0, action="submitted", job_id="jobA", name="a"),
        _ev("job", 2.0, action="submitted", job_id="jobB", name="b"),
        _ev("service", 40.0, action="stopped")])
    _write_jsonl(spool / "jobs" / "jobA" / "events.jsonl", [
        _ev("run_header", 3.0, run_id="ra", mode="median", model="CNNModel"),
        _ev("round", 5.0, run_id="ra", round=1, broadcast=1, ok=True, seconds=1.0,
            phases={"train": 0.5}),
        _ev("attribution", 5.0, run_id="ra", round=1, broadcast=1, mode="median",
            attackers=[0, 1], kept=[1, 2, 3], removed=[0]),
        _ev("round", 7.0, run_id="ra", round=2, broadcast=2, ok=True, seconds=1.0,
            phases={"train": 0.6}),
        _ev("attribution", 7.0, run_id="ra", round=2, broadcast=2, mode="median",
            attackers=[0, 1], kept=[2, 3], removed=[0, 1])])
    _write_jsonl(spool / "jobs" / "jobB" / "events.jsonl", [
        _ev("run_header", 4.0, run_id="rb", mode="fedavg", model="CNNModel"),
        _ev("round", 6.0, run_id="rb", round=1, broadcast=1, ok=True, seconds=1.0,
            phases={"train": 0.7})])
    # a job directory without a stream is not a source
    (spool / "jobs" / "jobC").mkdir()
    return str(spool)


def _v12(root) -> str:
    run = root / "v12"
    run.mkdir()
    shutil.copy(DATA / "events.v12.jsonl", run / "events.jsonl")
    return str(run)


def _untimed(root) -> str:
    run = root / "untimed"
    _write_jsonl(run / "events.0.jsonl", [{"kind": "run_header", "run_id": "u"},
                                          {"kind": "round", "run_id": "u", "round": 1}])
    _write_jsonl(run / "events.1.jsonl", [{"kind": "round", "run_id": "u", "round": 1,
                                           "ts": 3.0}])
    return str(run)


def _torn(root) -> str:
    run = root / "torn"
    shutil.copytree(DATA / "multihost", run)
    with open(run / "events.1.jsonl", "a") as fh:
        fh.write('{"schema": 1, "kind": "round", "ts": 10')
    return str(run)


INPUTS = {"multihost": _multihost, "processes": _processes, "spool": _spool, "v12": _v12,
          "untimed": _untimed, "torn": _torn}


def _both(capsys, argv: list) -> tuple:
    """``metrics <argv>`` through the port's command line and JAX's main:
    (exit code, stdout, stderr) of each."""
    rc = cli.main(["metrics", *argv])
    ours = capsys.readouterr()
    jrc = jsummary.main(argv)
    theirs = capsys.readouterr()
    return (rc, ours.out, ours.err), (jrc, theirs.out, theirs.err)


def test_committed_corpus_merges_with_jaxs_exact_skew():
    merged, per_process = merge.merge_events(str(DATA / "multihost"))
    assert (merged, per_process) == jmerge.merge_events(str(DATA / "multihost"))
    assert per_process == {0: 8, 1: 5}
    stamps = [e["ts"] for e in merged]
    assert stamps == sorted(stamps)
    skew = merge.skew_summary(merged)
    assert skew == jmerge.skew_summary(merged)
    assert skew["processes"] == [0, 1]
    assert skew["run_headers"] == {"mh0011223344": [0, 1]}
    assert skew["rounds_compared"] == 2
    assert skew["completion_skew_s"]["max"] == pytest.approx(0.3)
    assert skew["completion_skew_s"]["max_round"] == 2
    assert skew["completion_skew_s"]["p50"] == pytest.approx(0.21)
    train = skew["phase_lag_s"]["train"]
    assert train["max"] == pytest.approx(0.04) and train["max_round"] == 1
    assert train["mean"] == pytest.approx(0.03)
    agg = skew["phase_lag_s"]["aggregate"]
    assert agg["max"] == pytest.approx(0.01) and agg["max_round"] == 2


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_merge_functions_equal_jaxs(name, tmp_path):
    path = INPUTS[name](tmp_path)
    assert merge.is_spool(path) == jmerge.is_spool(path) == (name == "spool")
    assert merge.find_process_files(path) == jmerge.find_process_files(path)
    assert merge.find_spool_files(path) == jmerge.find_spool_files(path)
    merged, per_process = merge.merge_events(path)
    assert (merged, per_process) == jmerge.merge_events(path)
    skew = merge.skew_summary(merged)
    assert skew == jmerge.skew_summary(merged)
    assert merge.format_merge_report(merged, per_process, skew) == jmerge.format_merge_report(
        merged, per_process, skew)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("flags", [[], ["--json"], ["--forensics"], ["--forensics", "--json"],
                                   ["--numerics"], ["--programs"]])
def test_metrics_merge_prints_jaxs(name, flags, tmp_path, capsys):
    ours, theirs = _both(capsys, [INPUTS[name](tmp_path), "--merge", *flags])
    assert ours == theirs
    if not flags:
        assert ours[0] == 0 and ours[1].startswith("merged ")
    if flags == ["--forensics"]:
        # attribution events: the committed corpus (and its torn copy), the
        # two-process run and the spool's job A; none in v12's or untimed
        assert ours[0] == (2 if name in ("v12", "untimed") else 0)


def test_merge_forensics_over_a_spool_breaks_down_by_defense(tmp_path, capsys):
    ours, theirs = _both(capsys, [_spool(tmp_path), "--merge", "--forensics", "--json"])
    assert ours == theirs and ours[0] == 0
    assert set(json.loads(ours[1])["by_defense"]) == {"median"}
    # --run-id keeps the per-run rule on the merged stream
    ours, theirs = _both(capsys, [_spool(tmp_path / "again"), "--merge", "--forensics",
                                  "--run-id", "ra"])
    assert ours == theirs and ours[0] == 0


def test_merge_spool_stamps_job_ids(tmp_path):
    merged, sources = merge.merge_events(_spool(tmp_path))
    assert sources == {merge.SERVICE_KEY: 4, "jobA": 5, "jobB": 2}
    assert [e["job_id"] for e in merged if e["kind"] == "round"] == ["jobA", "jobB", "jobA"]
    assert all("job_id" not in e for e in merged if e["kind"] == "service")


@pytest.mark.parametrize("where", ["empty", "missing", "file"])
def test_metrics_merge_error_paths_as_jaxs(where, tmp_path, capsys):
    path = tmp_path / "run"
    if where == "empty":
        path.mkdir()
    elif where == "file":
        _write_jsonl(path, [])
    ours, theirs = _both(capsys, [str(path), "--merge"])
    assert ours == theirs and ours[0] == 2 and "no events*.jsonl" in ours[2]
