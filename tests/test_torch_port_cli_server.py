"""The port's launch surface against the JAX package's, on the CPU:
``python -m attackfl_tpu_torch client`` / ``server`` (the file
rendezvous of ``attackfl_tpu/cli.py:56-310``) and ``{log_path}/app.log``
(``attackfl_tpu/telemetry/console.py:28-51``).

Registrations written by either package's client are read by either
package's server into the same attack specs; every flag of JAX's
``server_main`` sets the Config field JAX's sets, and each runs
(``--pipeline`` and ``--pipeline-depth`` the pipelined executor,
``--hotspots`` and ``--profile-rounds`` their profiling window,
``--coordinator`` a process of a multi-process run, which fails within
the group's timeout when its coordinator never answers); a server run from three
registrations prints JAX's ``Finished`` line; a 3-broadcast run of each
package under ``nan_storm@2`` writes the same ``app.log`` lines once the
timestamps are cut and the numbers masked.
"""

import datetime
import json
import os
import re
import socket
import time

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu import cli as jcli
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.config import parse_profile_rounds as jax_parse_profile_rounds
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.training.engine import Simulator as JaxSimulator
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.parallel import mesh
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator

YAML = ("server: {num-round: 2, clients: 3, data-name: ICU, model: TransformerModel,\n"
        "         train-size: 128, test-size: 64,\n"
        "         data-distribution: {num-data-range: [16, 24]}}\n"
        "learning: {epoch: 1, batch-size: 16}\n"
        "tpu: {local-backend: pallas}\n"
        "log_path: {log}\n")


def _yaml(tmp_path, name="cfg.yaml") -> str:
    path = tmp_path / name
    path.write_text(YAML.replace("{log}", str(tmp_path)))
    return str(path)


def _events(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _spec(spec) -> tuple:
    return (spec.mode, tuple(spec.client_ids), spec.attack_round, tuple(spec.args))


def test_registrations_are_read_alike_by_both_packages(tmp_path, capsys):
    cfg_path = _yaml(tmp_path)
    jcli.client_main(["--config", cfg_path, "--attack", "True", "--attack_mode", "LIE",
                      "--attack_round", "1", "--attack_args", "0.5"])
    jcli.client_main(["--config", cfg_path])
    assert cli.main(["client", "--config", cfg_path, "--attack", "True", "--attack_mode",
                     "Min-Max", "--attack_round", "2", "--attack_args", "50", "1"]) == 0
    # the reference's `--attack False` registers a benign client
    assert cli.main(["client", "--config", cfg_path, "--attack", "False"]) == 0
    assert cli.main(["client", "--config", cfg_path, "--attack"]) == 1
    assert "--attack_mode is required" in capsys.readouterr().out
    reg_dir = tmp_path / cli.REG_DIR
    saved = {n: (reg_dir / n).read_bytes() for n in os.listdir(reg_dir)}
    assert len(saved) == 4 and all(n.endswith(".json") for n in saved)

    jregs = jcli._collect_registrations(JaxConfig(total_clients=4), str(tmp_path), timeout=5)
    assert os.listdir(reg_dir) == []
    for name, data in saved.items():
        (reg_dir / name).write_bytes(data)
    regs = cli._collect_registrations(Config(total_clients=4), str(tmp_path), timeout=5)
    assert regs == jregs and os.listdir(reg_dir) == []
    ours = [_spec(s) for s in cli._attacks_from_registrations(regs)]
    theirs = [_spec(s) for s in jcli._attacks_from_registrations(jregs)]
    assert ours == theirs and len(ours) == 2
    assert sorted(s[0] for s in ours) == ["LIE", "Min-Max"]
    assert {s[0]: s[2:] for s in ours} == {"LIE": (1, (0.5,)), "Min-Max": (2, (50.0, 1.0))}


def test_registration_wait_times_out(tmp_path):
    cfg_path = _yaml(tmp_path)
    assert cli.main(["client", "--config", cfg_path]) == 0
    with pytest.raises(TimeoutError, match="only 1/3 clients registered"):
        cli._collect_registrations(Config(total_clients=3), str(tmp_path), timeout=0.6)


def test_server_runs_from_three_registrations(tmp_path, capsys):
    cfg_path = _yaml(tmp_path)
    for argv in ([], ["--attack", "True", "--attack_mode", "LIE", "--attack_round", "1"], []):
        assert cli.main(["client", "--config", cfg_path, *argv]) == 0
    assert cli.main(["server", "--config", cfg_path, "--device", "cpu", "--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert "Server is waiting for 3 clients." in out
    assert "All clients are connected. Sending notifications." in out
    assert "\033[92mFinished: 2 successful rounds.\033[0m" in out
    assert os.listdir(tmp_path / cli.REG_DIR) == []
    log = (tmp_path / "app.log").read_text()
    assert "### Application start ###" in log and "roc_auc=" in log


def test_coordinator_without_no_wait_exits_1(tmp_path, capsys):
    assert cli.main(["server", "--config", _yaml(tmp_path), "--coordinator",
                     "localhost:1234"]) == 1
    assert "--coordinator requires --no-wait" in capsys.readouterr().out


@pytest.mark.parametrize("flags,depth", [(["--pipeline"], 1), (["--pipeline-depth", "2"], 2)])
def test_pipeline_flags_reach_the_config_and_run(flags, depth, tmp_path, capsys, monkeypatch):
    """``--pipeline`` and ``--pipeline-depth K`` set ``Config.pipeline``
    (and its depth) and the run goes through the pipelined executor."""
    runs = []
    run = engine.Simulator.run

    def recording(sim, *args, **kwargs):
        state, history = run(sim, *args, **kwargs)
        runs.append((sim.cfg, history))
        return state, history

    monkeypatch.setattr(engine.Simulator, "run", recording)
    assert cli.main(["server", "--config", _yaml(tmp_path), "--device", "cpu", "--no-wait",
                     "--rounds", "2", *flags]) == 0
    (cfg, history), = runs
    assert cfg.pipeline and cfg.pipeline_depth == depth
    assert [h["pipelined"] for h in history] == [True, True]
    assert "\033[92mFinished: 2 successful rounds.\033[0m" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    (["--monitor", "--profile-rounds", "1:2"], None),
    (["--monitor-port", "0", "--hotspots", "2"], None),
    (["--profile-rounds", "1:2"], None),
    (["--hotspots", "1:2"], None),
    (["--numerics", "--hotspots", "1:2"], None),
    pytest.param(["--coordinator", "localhost:1234", "--num-processes", "2",
                  "--process-id", "1"], "unanswered", id="flags5-item 14"),
])
def test_unported_flags_are_refused_with_their_item(flags, item, tmp_path, monkeypatch,
                                                    capsys):
    """What was refused until it was ported runs.  The multi-host flags
    (ROADMAP item 14b) are accepted: process 1 of 2, whose coordinator
    never answers, exits 1 within the group's timeout instead of hanging.
    The profiling and hotspot windows (item 16c) run and write their
    window: ``--hotspots 2`` is the window 2:2, as JAX's server reads it."""
    argv = ["server", "--config", _yaml(tmp_path), "--device", "cpu", "--no-wait", *flags]
    if item == "unanswered":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            silent = f"127.0.0.1:{s.getsockname()[1]}"      # closed again: nobody answers
        monkeypatch.setattr(mesh, "DIST_TIMEOUT", datetime.timedelta(seconds=2))
        t0 = time.monotonic()
        assert cli.main([silent if a == "localhost:1234" else a for a in argv]) == 1
        assert time.monotonic() - t0 < 60
        assert f"process 1 of 2 could not join the process group at {silent}" in \
            capsys.readouterr().out
        return
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    assert cli.main(argv) == 0
    spec = flags[flags.index("--hotspots" if "--hotspots" in flags else "--profile-rounds") + 1]
    (event,) = [e for e in _events(tmp_path / "events.jsonl") if e["kind"] == "hotspot"]
    assert event["status"] == "ok" and event["program"] == "sync"
    assert (event["round_first"], event["round_last"]) == jax_parse_profile_rounds(spec)
    assert os.path.isfile(tmp_path / event["trace"])


class _Built(Exception):
    """Raised by the stand-in Simulator with the Config it was given."""


def _capture_cfg(monkeypatch, module: str, main, argv) -> object:
    def fake(cfg, *args, **kwargs):
        raise _Built(cfg)

    monkeypatch.setattr(f"{module}.training.engine.Simulator", fake)
    with pytest.raises(_Built) as built:
        main(argv)
    return built.value.args[0]


FIELDS = ("pipeline", "pipeline_depth", "checkpoint_async", "resume", "validation_every",
          "validation_async", "compile_cache_dir")
TELEMETRY = ("monitor", "monitor_port", "profile_rounds", "hotspots", "numerics")


def test_every_server_flag_sets_jax_s_config_field(tmp_path, monkeypatch):
    cfg_path = _yaml(tmp_path)
    argv = ["--config", cfg_path, "--no-wait", "--pipeline-depth", "auto", "--checkpoint-async",
            "--resume", "--inject-faults", "nan_storm@2:clients=1;ckpt_torn@3",
            "--validation-every", "2", "--validation-async", "--compile-cache",
            str(tmp_path / "cache"), "--monitor-port", "0", "--profile-rounds", "1:2",
            "--hotspots", "2:3", "--numerics"]
    ours = _capture_cfg(monkeypatch, "attackfl_tpu_torch", cli.server_main, argv)
    theirs = _capture_cfg(monkeypatch, "attackfl_tpu", jcli.server_main, argv)
    assert [getattr(ours, f) for f in FIELDS] == [getattr(theirs, f) for f in FIELDS]
    assert [getattr(ours.telemetry, f) for f in TELEMETRY] == \
        [getattr(theirs.telemetry, f) for f in TELEMETRY]
    assert [s.describe() for s in ours.faults] == [s.describe() for s in theirs.faults]
    assert ours.pipeline and ours.telemetry.monitor and ours.validation_every == 2


def _app_log_lines(path) -> list[str]:
    """app.log's lines without their timestamps, every number masked."""
    lines = []
    for line in open(path).read().splitlines():
        _stamp, level, msg = line.split(" - ", 2)
        lines.append(f"{level} - " + re.sub(r"nan|-?\d+(\.\d+)?", "#", msg))
    return lines


def test_app_log_lines_match_jax(tmp_path):
    """Three broadcasts (the second stormed) through each package's
    synchronous run."""
    shared = dict(num_round=2, total_clients=4, mode="fedavg", model="TransformerModel",
                  data_name="ICU", num_data_range=(16, 24), epochs=1, batch_size=16,
                  train_size=128, test_size=64, local_backend="pallas")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_sim = JaxSimulator(JaxConfig(**shared, log_path=str(jdir), checkpoint_dir=str(jdir),
                                       faults=jax_parse_fault_plan("nan_storm@2"),
                                       telemetry=JaxTelemetryConfig(enabled=False)))
    _, jhist = jax_sim.run(save_checkpoints=False, verbose=False)
    sim = Simulator(Config(**shared, log_path=str(tdir), checkpoint_dir=str(tdir),
                           faults=parse_fault_plan("nan_storm@2")), device="cpu")
    _, hist = sim.run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in hist] == [h["ok"] for h in jhist] == [True, False, True]
    ours, theirs = _app_log_lines(tdir / "app.log"), _app_log_lines(jdir / "app.log")
    assert ours == theirs == ["INFO - ### Application start ###",
                              "INFO - metric=# roc_auc=#",
                              "WARNING - Round # failed (retry #)",
                              "INFO - metric=# roc_auc=#"]
