"""The port's cost model (``attackfl_tpu_torch/costmodel``) on the CPU,
against the JAX package's jax-free halves.

1. The counter on programs counted by hand: a Linear, a tanh and a sum; a
   convolution; views, which count zero.
2. The kernels' formulas: ``run_epoch`` and ``fill_masks`` count
   ``epoch_work`` and ``mask_work``, and none of their plain versions'
   ops.
3. In-run profiles on every executor and in hyper mode at
   ``test_torch_port_fused_rounds.py``'s size: JAX's program names and
   ``rounds_per_dispatch``, the same counts from a second Simulator, the
   params bit for bit with the cost model on and off, no profile under
   ``ATTACKFL_COSTMODEL=0``; ``cost estimate``'s count on fake tensors
   equals the in-run count of config 4 (cut) under each backend.
4. The torch-free halves against JAX's on the same inputs:
   ``per_round_cost``, ``utilization_summary`` (the H100 row given to
   both), ``programs_summary``, ``format_programs``, ``peer_prediction``,
   ``fit_regression``, ``validate_predictions``, the ``cost`` command's
   exit codes, ``metrics --programs``, the monitor's ``/programs`` and
   gauges.
5. The port's count against XLA's ``cost_analysis`` of the same
   ``round_step``, printed and not gated: eager per-op traffic against a
   post-fusion count (``ROADMAP.md`` §3).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.costmodel import cli as jcost_cli
from attackfl_tpu.costmodel import estimate as jestimate
from attackfl_tpu.costmodel import peaks as jpeaks
from attackfl_tpu.costmodel import report as jreport
from attackfl_tpu.costmodel import roofline as jroofline
from attackfl_tpu.costmodel.capture import compiled_profile
from attackfl_tpu.telemetry import summary as jsummary
from attackfl_tpu.telemetry.monitor import RunMonitor as JaxRunMonitor
from attackfl_tpu.training.engine import Simulator as JaxSimulator
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.costmodel import cli as cost_cli
from attackfl_tpu_torch.costmodel import estimate, peaks, report, roofline
from attackfl_tpu_torch.costmodel.capture import count_program
from attackfl_tpu_torch.ops import fused_step as fs
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.monitor import RunMonitor
from attackfl_tpu_torch.training.engine import Simulator
from test_torch_port_fused_rounds import SMALL

DATA = Path(__file__).resolve().parent / "data"
H100_ROW = {"h100 80gb hbm3": peaks.H100}


@pytest.fixture()
def costmodel_on(monkeypatch):
    """The suite runs with ``ATTACKFL_COSTMODEL=0``; these tests turn it on."""
    monkeypatch.setenv("ATTACKFL_COSTMODEL", "1")


def test_the_counter_on_programs_counted_by_hand():
    x, w, b = torch.randn(8, 16), torch.randn(4, 16), torch.randn(4)
    _, p = count_program(lambda a: torch.tanh(torch.nn.functional.linear(a, w, b)).sum(), x)
    # addmm 2*8*16*4, tanh and sum one per element of [8, 4]
    assert (p["flops"], p["transcendentals"]) == (2 * 8 * 16 * 4 + 32 + 32, 32)
    # addmm reads bias [4], x [8, 16] and w.t() [16, 4], writes [8, 4];
    # tanh reads and writes [8, 4]; sum reads [8, 4] and writes one float
    assert p["bytes_accessed"] == 4 * ((4 + 128 + 64 + 32) + (32 + 32) + (32 + 1))
    assert "memory" not in p          # the CPU has no allocator to read
    image, kernel = torch.randn(2, 3, 8, 8), torch.randn(5, 3, 3, 3)
    _, p = count_program(lambda a: torch.nn.functional.conv2d(a, kernel), image)
    assert p["flops"] == 2 * (2 * 5 * 6 * 6) * 3 * 3 * 3
    assert p["bytes_accessed"] == 4 * (2 * 3 * 8 * 8 + 5 * 3 * 3 * 3 + 2 * 5 * 6 * 6)
    _, p = count_program(lambda a: a.reshape(-1)[::2].expand(3, -1).t().unsqueeze(0), x)
    assert (p["flops"], p["bytes_accessed"], p["transcendentals"]) == (0, 0, 0)
    # a reshape that must copy is a copy: its bytes, no flops
    _, p = count_program(lambda a: a.t().reshape(-1), x)
    assert (p["flops"], p["bytes_accessed"]) == (0, 2 * 4 * 128)
    # a broadcast operand is read once
    _, p = count_program(lambda a: a + b.expand(8, 4), torch.randn(8, 4))
    assert p["bytes_accessed"] == 4 * (32 + 4 + 32) and p["flops"] == 32


def test_the_kernels_count_by_their_formulas():
    C, nb, B = 3, 2, 5
    gen = torch.Generator().manual_seed(0)
    groups = {k: torch.randn((C,) + s, generator=gen) * 0.1 for k, s in fs.GROUP_SHAPES.items()}
    m, v = fs.zeros_like_groups(groups), fs.zeros_like_groups(groups)
    batches = torch.rand((C, nb, B, 32), generator=gen)
    _, p = count_program(fs.run_epoch, groups, m, v, batches, 7, 0, lr=1e-3, clip=1.0)
    work = fs.epoch_work(C, nb, B)
    assert (p["flops"], p["bytes_accessed"], p["ops"]) == (work["flops"], work["bytes"], 0)
    specs = [(0, 16, 64, 0.1), (1, 16, 8, 0.3)]
    keys = fs.client_keys(1, 2, torch.arange(C))
    _, p = count_program(fs.fill_masks, keys, specs)
    work = fs.mask_work(C, specs)
    assert (p["flops"], p["bytes_accessed"], p["ops"]) == (work["flops"], work["bytes"], 0)
    assert work["bytes"] == 4 * C * (16 * 64 + 16 * 8) + 8 * C


EXECUTORS = {"run": ({}, {"round_step": 1, "aggregate": 1}),
             "run_fast": ({"chunk_size": 2}, {"fused_scan[2]": 2, "fused_scan[1]": 1}),
             "pipeline": ({}, {"pipeline_step[eval=True]": 1})}


def _run(tmp_path, name: str, how: str, backend: str = "xla", **kw):
    directory = tmp_path / name
    cfg = Config(**{**SMALL, "local_backend": backend, "log_path": str(directory),
                    "pipeline": how == "pipeline", "pipeline_depth": 2, **kw})
    sim = Simulator(cfg, device="cpu")
    if how == "run_fast":
        state, _ = sim.run_fast(save_checkpoints=False, verbose=False, **EXECUTORS[how][0])
    else:
        state, _ = sim.run(save_checkpoints=False, verbose=False)
    sim.close()
    with open(directory / "events.jsonl") as fh:
        profiles = [json.loads(line) for line in fh]
    return state, [e for e in profiles if e["kind"] == "program_profile"]


def _same_params(a: dict, b: dict, key: str = "global_params") -> bool:
    return all(torch.equal(x, y) for x, y in zip(pt.tree_leaves(a[key]), pt.tree_leaves(b[key])))


@pytest.mark.parametrize("how", list(EXECUTORS))
def test_in_run_profiles_on_every_executor(how, tmp_path, monkeypatch, costmodel_on):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "a"))
    state, profiles = _run(tmp_path, "a", how)
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "b"))
    again, second = _run(tmp_path, "b", how)
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "off"))
    off, none = _run(tmp_path, "off", how, telemetry=TelemetryConfig(costmodel=False))
    monkeypatch.setenv("ATTACKFL_COSTMODEL", "0")
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "env"))
    _, none_env = _run(tmp_path, "env", how)
    names = {e["program"]: e["rounds_per_dispatch"] for e in profiles}
    assert names == EXECUTORS[how][1]
    assert all(e["device_kind"] == "cpu" and e["flops"] > 0 and e["bytes_accessed"] > 0
               for e in profiles)
    keys = ("program", "flops", "transcendentals", "bytes_accessed", "rounds_per_dispatch")
    assert [[e[k] for k in keys] for e in profiles] == [[e[k] for k in keys] for e in second]
    assert none == none_env == []
    assert _same_params(state, off) and _same_params(state, again)


def test_in_run_profiles_in_hyper_mode(tmp_path, monkeypatch, costmodel_on):
    hyper = dict(mode="hyper", hyper_lr=0.001)
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "on"))
    state, profiles = _run(tmp_path, "on", "run", **hyper)
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "off"))
    off, _ = _run(tmp_path, "off", "run", telemetry=TelemetryConfig(costmodel=False), **hyper)
    assert sorted(e["program"] for e in profiles) == ["hyper_update", "round_step"]
    assert torch.equal(state["hnet_params"], off["hnet_params"])
    assert all(torch.equal(state["hyper_opt_state"][k], off["hyper_opt_state"][k])
               for k in ("count", "m", "v"))
    # hyper_update reads values, so it is counted only from a real dispatch
    cfg = Config(**{**SMALL, "local_backend": "xla", **hyper})
    assert set(cost_cli.count_sync_programs(cfg, "cpu")) <= {"round_step"}


CONFIG4_CUT = dict(num_round=1, total_clients=100, mode="fedavg", model="TransformerModel",
                   data_name="ICU", batch_size=128, lr=0.004, clip_grad_norm=1.0,
                   genuine_rate=0.5, train_size=20000, test_size=4000, random_seed=1,
                   epochs=2, num_data_range=(1200, 1500),
                   attacks=(AttackSpec(mode="LIE", num_clients=25, attack_round=2,
                                       args=(0.74,)),))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_the_count_without_a_run_equals_the_in_run_count(backend, tmp_path, monkeypatch,
                                                         costmodel_on):
    """Config 4 (cut): ``cost estimate``'s count of round_step and
    aggregate on fake tensors is the count of the first round's real
    dispatch, flops, transcendentals and bytes."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    cfg = Config(**CONFIG4_CUT, local_backend=backend, validation=False)
    fake = cost_cli.count_sync_programs(cfg, "cpu")
    sim = Simulator(cfg, device="cpu")
    sim.run_round(sim.init_state())
    sim.close()
    keys = ("flops", "transcendentals", "bytes_accessed")
    assert {n: [p[k] for k in keys] for n, p in fake.items()} == \
        {n: [p[k] for k in keys] for n, p in sim._program_profiles.items()}
    if backend == "pallas":
        nb = -(-1500 // 128)
        k1 = 2 * fs.epoch_work(100, nb, 128)["flops"]
        assert fake["round_step"]["flops"] > k1 > 0.98 * fake["round_step"]["flops"]


@pytest.fixture()
def h100_in_both(monkeypatch):
    monkeypatch.setattr(jpeaks, "PEAK_SPECS", {**jpeaks.PEAK_SPECS, **H100_ROW})


PROGRAMS = {"round_step": {"flops": 53_791_000_000, "transcendentals": 1_200,
                           "bytes_accessed": 1_900_000_000, "rounds_per_dispatch": 1,
                           "memory": {"argument": 1, "output": 2, "temp": 3, "alias": 0,
                                      "peak": 6}},
            "aggregate": {"flops": 31_000_000, "bytes_accessed": 250_000_000,
                          "rounds_per_dispatch": 1},
            "fused_scan[3]": {"flops": 162_000_000_000, "bytes_accessed": 5_800_000_000,
                              "rounds_per_dispatch": 3}}


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu", "", None])
@pytest.mark.parametrize("names", [("round_step", "aggregate"), ("fused_scan[3]",),
                                   ("round_step",)])
def test_per_round_cost_and_utilization_as_jaxs(kind, names, h100_in_both):
    programs = {n: PROGRAMS[n] for n in names}
    assert roofline.per_round_cost(programs) == jroofline.per_round_cost(programs)
    for seconds in (0.0214, None, 0):
        assert roofline.utilization_summary(programs, seconds, kind) == \
            jroofline.utilization_summary(programs, seconds, kind)
    assert peaks.peak_for(kind) == jpeaks.peak_for(kind)


def test_programs_summary_and_metrics_programs_as_jaxs(tmp_path, capsys):
    path = DATA / "events.v9.jsonl"
    events = [json.loads(line) for line in open(path)]
    assert report.programs_summary(events) == jreport.programs_summary(events)
    summary = report.programs_summary(events)
    assert report.format_programs(summary, "r") == jreport.format_programs(summary, "r")
    assert report.profiles_from_events(events) == jreport.profiles_from_events(events)
    for flags in ([], ["--json"], ["--all"]):
        assert cli.main(["metrics", str(path), "--programs", *flags]) == 0
        ours = capsys.readouterr().out
        assert jsummary.main([str(path), "--programs", *flags]) == 0
        assert ours == capsys.readouterr().out


def _corpus() -> list:
    with open(DATA / "ledger_corpus" / "ledger.jsonl") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_prediction_as_jaxs_on_its_ledger_corpus():
    records = _corpus()
    fingerprints = sorted({r.get("fingerprint") for r in records if r.get("fingerprint")})
    for fp in fingerprints + ["no-such-fingerprint"]:
        assert estimate.peer_prediction(records, fp) == jestimate.peer_prediction(records, fp)
        assert estimate.fit_regression(records, exclude_fingerprint=fp) == \
            jestimate.fit_regression(records, exclude_fingerprint=fp)
        profile = {"flops_per_round": 1e12, "bytes_per_round": 1e9}
        assert estimate.predict_run(records, fp, 5, profile) == \
            jestimate.predict_run(records, fp, 5, profile)
    assert estimate.validate_predictions(records) == jestimate.validate_predictions(records)
    assert estimate.prediction_error_factor(2.0, 0.5) == \
        jestimate.prediction_error_factor(2.0, 0.5) == 4.0


def test_the_cost_command_exits_as_jaxs(tmp_path, capsys):
    corpus = str(DATA / "ledger_corpus")
    empty = tmp_path / "empty"
    empty.mkdir()
    for argv in (["validate", "--dir", corpus], ["validate", "--dir", corpus, "--json"],
                 ["validate", "--dir", str(empty)],
                 ["validate", "--dir", corpus, "--max-median-factor", "1.0"]):
        ours = cost_cli.main(argv)
        our_out = capsys.readouterr().out
        assert ours == jcost_cli.main(argv), argv
        assert our_out == capsys.readouterr().out
    config = tmp_path / "config.yaml"
    config.write_text("server: {num-round: 2, clients: 3, model: TransformerModel}\n")
    for directory in (str(empty), corpus):
        argv = ["estimate", "--config", str(config), "--dir", directory, "--no-compile",
                "--json"]
        assert cost_cli.main(argv) == jcost_cli.main(argv) == 2
    # --matrix prices the grid cell by cell: each cell with a peer in the
    # ledger (a measured record of its standalone config), as JAX's
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text("server: {num-round: 2, clients: 3, model: TransformerModel}\n"
                     "matrix: {attacks: [LIE, none], attack-clients: 1, "
                     "defenses: [fedavg, krum, gmm], seeds: [1, 2], rounds: 4}\n")
    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.ledger.store import LedgerStore
    from attackfl_tpu_torch.matrix.grid import cell_config, expand_cells, grid_from_dict
    from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

    grid = grid_from_dict({"attacks": ["LIE", "none"], "attack-clients": 1,
                           "defenses": ["fedavg", "krum", "gmm"], "seeds": [1, 2],
                           "rounds": 4})
    peers = LedgerStore(str(tmp_path / "peers"))
    for i, cell in enumerate(expand_cells(grid)):
        fingerprint = config_fingerprint(cell_config(load_config(str(sweep)), cell, rounds=4))
        peers.append({"ledger_schema": 1, "ts": 1.0 + i, "source": "run",
                      "fingerprint": fingerprint, "rounds": 4,
                      "round_device_time": 0.25 + 0.01 * i, "host_resolution_latency": 0.05})
    capsys.readouterr()
    for directory in (str(tmp_path / "peers"), str(empty)):
        argv = ["estimate", "--matrix", "--config", str(sweep), "--dir", directory,
                "--no-compile", "--json"]
        ours = cost_cli.main(argv)
        our_out = capsys.readouterr().out
        assert ours == jcost_cli.main(argv) == 0
        theirs = capsys.readouterr().out
        if directory == str(empty):
            # peerless cells: the port says why, JAX does not
            our_out = json.dumps({**json.loads(our_out), "cells": [
                {k: v for k, v in c.items() if k != "reason"}
                for c in json.loads(our_out)["cells"]]})
            theirs = json.dumps(json.loads(theirs))
        assert json.loads(our_out) == json.loads(theirs)
    argv = ["estimate", "--matrix", "--config", str(sweep), "--dir", str(tmp_path / "peers")]
    assert cost_cli.main(argv) == jcost_cli.main(argv) == 0
    text = capsys.readouterr().out.split("cost estimate")
    assert text[1] == text[2] and "predicted sweep wall (serial bound)" in text[1]


def test_the_cost_command_prices_a_config(tmp_path, capsys, costmodel_on, monkeypatch):
    """Peerless with an empty ledger: the count on fake tensors, and no
    record to regress on; with a measured record of another config in
    the ledger, the regression prices it; with its own, its peers."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    yaml = ("server: {num-round: 2, clients: 8, data-name: ICU, model: TransformerModel,\n"
            "         train-size: 256, test-size: 128,\n"
            "         data-distribution: {num-data-range: [24, 32]}}\n"
            "learning: {epoch: 1, batch-size: 16}\n"
            f"log_path: {tmp_path}\n")
    config = tmp_path / "config.yaml"
    config.write_text(yaml)
    ledger = str(tmp_path / "ledger")
    argv = ["cost", "estimate", "--config", str(config), "--dir", ledger, "--device", "cpu",
            "--json"]
    assert cli.main(argv) == 2
    out = json.loads(capsys.readouterr().out)
    assert out["method"] == "unpredictable" and "regress" in out["reason"]
    other = tmp_path / "other.yaml"
    other.write_text(yaml.replace("clients: 8", "clients: 6"))
    assert cli.main(["run", "--config", str(other), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["method"] in ("regression", "flops_ratio") and out["profile"]["flops_per_round"]
    assert cli.main(["run", "--config", str(config), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out)["method"] == "peer"


def test_the_monitor_answers_programs_as_jaxs(h100_in_both):
    monitors = [RunMonitor(Telemetry.disabled(), port=0), JaxRunMonitor(
        Telemetry.disabled(), port=0)]
    programs = {n: dict(PROGRAMS[n], device_kind="NVIDIA H100 80GB HBM3")
                for n in ("round_step", "aggregate")}
    lines = []
    for monitor in monitors:
        assert monitor.cost_report()["programs"] == {}
        monitor.set_cost_model(programs)
        for seconds in (0.031, 0.027, 0.029):
            monitor.record_round({"round": 1, "ok": True}, duration=seconds)
        lines.append([line for line in monitor.metrics_text().splitlines()
                      if line.split("{")[0].split(" ")[-1].startswith(
                          ("attackfl_program", "attackfl_utilization", "attackfl_achieved"))])
    assert monitors[0].cost_report() == monitors[1].cost_report()
    assert lines[0] == lines[1] and len(lines[0]) == 8
    assert 0 < monitors[0].cost_report()["utilization"]["utilization_flops"] < 1


def test_the_ports_count_against_xlas(tmp_path, monkeypatch, costmodel_on, capsys):
    """Written down, not gated: the port's round_step flops against XLA's
    ``cost_analysis`` of JAX's round_step on the same config, on the CPU.
    XLA counts a ``while`` body (the local update's loop over minibatches)
    once, not times its trip count, and fuses what eager PyTorch runs op
    by op."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    base = {**SMALL, "local_backend": "xla", "num_round": 1}
    ours = cost_cli.count_sync_programs(Config(**base), "cpu")["round_step"]
    sim = JaxSimulator(JaxConfig(**base, log_path=str(tmp_path)))
    name, fn, args = sim.sync_profile_programs()[0]
    theirs = compiled_profile(fn.lower(*args).compile())
    sim.close()
    assert name == "round_step" and theirs["flops"] > 0
    ratio = ours["flops"] / theirs["flops"]
    with capsys.disabled():
        print(f"\n[costmodel] round_step at {SMALL['total_clients']} clients, "
              f"{SMALL['epochs']} epochs of batch {SMALL['batch_size']}: the port counts "
              f"{ours['flops']} flops and {ours['bytes_accessed']} bytes, XLA "
              f"{theirs['flops']} flops and {theirs.get('bytes_accessed')} bytes: "
              f"ratio {ratio:.3f} (flops), "
              f"{ours['bytes_accessed'] / max(theirs.get('bytes_accessed', 1), 1):.3f} (bytes)")
    assert np.isfinite(ratio) and ratio > 0
