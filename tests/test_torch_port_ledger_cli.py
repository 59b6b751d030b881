"""The port's ``ledger`` command line (``attackfl_tpu_torch/ledger/cli.py``,
``compare.py`` and ``record.records_from_bench``) against the JAX
package's jax-free ``attackfl_tpu.ledger.cli``, on the CPU.

1. ``ledger list|show|compare|regress`` give JAX's stdout and exit code on
   the committed ``tests/data/ledger_corpus`` (the rolling baseline, a
   pinned baseline, the rate, quality and utilization gates, prefixes and
   missing ids), ``list --sweep`` and ``regress --sweeps`` on
   ``tests/data/science_corpus``, and every command on a store of records
   that two port runs on the CPU appended, which JAX's ``validate_record``
   passes.
2. ``records_from_bench`` gives JAX's records for each bench family, and
   ``ledger import`` of synthetic bench files written to ``tmp_path``
   imports JAX's records with JAX's exit codes.
"""

import json
from pathlib import Path

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.ledger import cli as jcli
from attackfl_tpu.ledger.record import records_from_bench as jax_records_from_bench
from attackfl_tpu.ledger.record import validate_record as jax_validate_record
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.ledger import cli
from attackfl_tpu_torch.ledger.record import records_from_bench, validate_record
from attackfl_tpu_torch.ledger.store import LedgerStore
from attackfl_tpu_torch.training.engine import Simulator

DATA = Path(__file__).resolve().parent / "data"
CORPUS = str(DATA / "ledger_corpus")
SCIENCE = str(DATA / "science_corpus")


def _both(argv, capsys):
    """``(stdout, exit code)`` of the port's and JAX's command on ``argv``."""
    out = []
    for main in (cli.main, jcli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
        out.append((capsys.readouterr().out, rc))
    return out


CORPUS_CASES = [
    ["list"], ["list", "--json"], ["list", "--fingerprint", "5caa55e38b3a9da0"],
    ["list", "--executor", "fused", "--json"],
    ["show", "base-r1"], ["show", "util-base-r2", "--json"], ["show", "slow"],
    ["show", "no-such-record"],
    ["compare", "base-r1", "slow-20pct"], ["compare", "base-r1", "slow-20pct", "--json"],
    ["compare", "slow-20pct"], ["compare", "util-drop", "--json"],
    ["compare", "23391291b091", "--json"],
    ["regress", "slow-20pct"], ["regress", "slow-20pct", "--json"],
    ["regress", "base-r2", "--json"], ["regress", "auc-drop", "--against", "base-r1"],
    ["regress", "util-drop", "--json"], ["regress", "--json"],
    ["regress", "slow-20pct", "--threshold-pct", "25", "--json"],
    ["regress", "slow-20pct", "--window", "1"],
]


@pytest.mark.parametrize("argv", CORPUS_CASES, ids=" ".join)
def test_ledger_commands_as_jaxs_on_the_corpus(argv, capsys):
    (port, port_rc), (jax, jax_rc) = _both(argv + ["--dir", CORPUS], capsys)
    assert port == jax
    assert port_rc == jax_rc


SWEEP_CASES = [["list", "--sweep", "base-a"], ["list", "--sweep", "flip", "--json"],
               ["regress", "--sweeps", "base-a", "base-b"],
               ["regress", "--sweeps", "base-a", "flip", "--json"],
               ["regress", "--sweeps", "base-a", "nope"]]


@pytest.mark.parametrize("argv", SWEEP_CASES, ids=" ".join)
def test_sweep_views_as_jaxs(argv, capsys):
    (port, port_rc), (jax, jax_rc) = _both(argv + ["--dir", SCIENCE], capsys)
    assert port == jax
    assert port_rc == jax_rc


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    """A ledger of two port CPU runs of one config (peers of one
    fingerprint) and a third of another executor."""
    root = tmp_path_factory.mktemp("port_ledger")
    cfg = Config(num_round=2, total_clients=4, model="CNNModel", data_name="ICU",
                 num_data_range=(24, 32), epochs=1, batch_size=16, train_size=128,
                 test_size=64, attacks=(AttackSpec(mode="LIE", num_clients=1,
                                                   attack_round=2),),
                 log_path=str(root), checkpoint_dir=str(root))
    with pytest.MonkeyPatch.context() as mp:
        # the runs write under their own log_path, not the suite's shared
        # telemetry directory
        mp.delenv("ATTACKFL_TELEMETRY_DIR", raising=False)
        mp.delenv("ATTACKFL_LEDGER_DIR", raising=False)
        for how in ("run", "run", "run_fast"):
            sim = Simulator(cfg, device="cpu")
            if how == "run_fast":
                sim.run_fast(chunk_size=2, save_checkpoints=False, verbose=False)
            else:
                sim.run(save_checkpoints=False, verbose=False)
            sim.close()
    return str(root / "ledger")


def test_port_records_pass_both_validators(port_store):
    records, skipped = LedgerStore(port_store).load()
    assert skipped == 0 and len(records) == 3
    for rec in records:
        assert validate_record(rec) == [] and jax_validate_record(rec) == []
    assert [r["executor"] for r in records] == ["sync", "sync", "fused"]


@pytest.mark.parametrize("argv", [
    ["list", "--json"], ["list"], ["show", "{0}"], ["show", "{2}", "--json"],
    ["compare", "{0}", "{1}", "--json"], ["compare", "{1}"], ["compare", "{0}", "{2}"],
    ["regress", "{1}", "--json"], ["regress", "{1}"], ["regress", "--json"],
    ["regress", "{2}", "--against", "{0}", "--json"],
], ids=" ".join)
def test_ledger_commands_as_jaxs_on_a_port_store(argv, port_store, capsys):
    ids = [r["record_id"] for r in LedgerStore(port_store).load()[0]]
    argv = [a.format(*ids) for a in argv]
    (port, port_rc), (jax, jax_rc) = _both(argv + ["--dir", port_store], capsys)
    assert port == jax
    assert port_rc == jax_rc


BENCH = {
    "headline": {"metric": "fl_rounds_per_sec_100c", "value": 3.25, "ts": 1.0,
                 "detail": {"config": "config4", "roc_auc_final": 0.81}},
    "wrapper": {"parsed": {"metric": "fl_e2e_3", "value": 1.5, "detail": {}}},
    "pipeline": {"metric": "fl_pipeline_vs_sync_100c", "detail": {
        "config": "c4", "sync": {"rounds_per_sec": 2.0, "per_rep": [1.9, 2.1]},
        "pipelined_async_ckpt": {"rounds_per_sec_steady": 2.6, "rounds_per_sec_mean": 2.5}}},
    "numerics": {"metric": "fl_numerics_on_100c", "detail": {
        "metrics_off": {"rounds_per_sec": 3.0}, "metrics_on": {"rounds_per_sec": 2.9},
        "overhead_pct": 3.3}},
    "matrix": {"metric": "fl_matrix_vs_serial", "detail": {
        "serial": {"rounds_per_sec": 1.0, "warm_wall_s": 10.0, "cold_wall_s": 12.0},
        "batched": {"rounds_per_sec": 4.0, "warm_wall_s": 2.5, "cold_wall_s": 5.0},
        "speedup_warm": 4.0}},
    "depth": {"metric": "fl_depth_sweep", "detail": {
        "by_depth": {"0": {"rounds_per_sec": 2.0}, "2": {"rounds_per_sec": 2.4},
                     "auto": {"rounds_per_sec": 2.3}}, "auto_pick": {"k": 2}}},
    "mesh": {"metric": "fl_mesh_sweep", "detail": {
        "by_devices": {"1": {"fused": {"rounds_per_sec": 1.0}},
                       "4": {"fused": {"rounds_per_sec": 3.5},
                             "matrix": {"rounds_per_sec": 3.0}}},
        "fused_speedup": {"4": 3.5}}},
    "contention": {"metric": "fl_contention", "detail": {
        "serialized": {"makespan_s_mean": 30.0, "mean_wait_s": 5.0, "jobs": 6},
        "scheduler": {"makespan_s_mean": 20.0, "per_rep": [19.0, 21.0]},
        "throughput_ratio": 1.5}},
    "cache": {"metric": "fl_compile_cache", "detail": {
        "first_run": {"backend_compile_s": 12.0, "cache_misses": 9},
        "warm_cache": {"backend_compile_s": 1.0, "cache_hits": 9}}},
    "empty": {"metric": "", "value": 1.0},
}


@pytest.mark.parametrize("family", sorted(BENCH))
def test_records_from_bench_as_jaxs(family):
    assert records_from_bench(json.loads(json.dumps(BENCH[family]))) == \
        jax_records_from_bench(json.loads(json.dumps(BENCH[family])))


def test_ledger_import_as_jaxs(tmp_path, capsys):
    files = []
    for name in ("headline", "pipeline", "depth", "empty"):
        path = tmp_path / f"BENCH_{name}.json"
        path.write_text(json.dumps(BENCH[name]))
        files.append(str(path))
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text("{not json")
    results = []
    for which, main in (("port", cli.main), ("jax", jcli.main)):
        store = tmp_path / which
        for argv in (files + ["--json"], files[:1]):
            rc = main(["import", *argv, "--dir", str(store)])
            out = capsys.readouterr().out
            results.append((which, rc, out))
        rc = main(["import", str(bad), "--dir", str(store), "--json"])
        results.append((which, rc, json.loads(capsys.readouterr().out)["skipped"]))
        records = [{k: v for k, v in r.items() if k != "record_id"}
                   for r in LedgerStore(str(store)).load()[0]]
        results.append((which, len(records), records))
    port, jax = results[:4], results[4:]
    assert port[0][1] == jax[0][1] == 0
    assert [len(json.loads(r[2])["imported"]) for r in (port[0], jax[0])] == [6, 6]
    assert json.loads(port[0][2])["skipped"] == json.loads(jax[0][2])["skipped"] == 1
    assert port[1][1] == jax[1][1] == 0
    assert port[2][1:] == jax[2][1:] == (2, 1)
    assert port[3][1:] == jax[3][1:]
