"""The port's ``serve`` and ``job`` commands as processes on the CPU.

``python -m attackfl_tpu_torch serve --device cpu`` as a daemon process:
``job submit|list|status|cancel|wait`` against it (the JAX package's
``job`` client prints the same lines against it), ``watch --schedule
--once``, ``watch --fleet --once`` and ``fleet report`` (JAX's lines on the
same daemon and spool), a ``kill -9`` mid-run with a torn queued entry recovered bit for bit
against a standalone port run, and SIGTERM draining with exit 0.  Without
``--device cpu`` the daemon needs a card, and refuses to start here.
"""

import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.cli import watch_main as jax_watch_main
from attackfl_tpu.service.cli import job_main as jax_job_main
from attackfl_tpu.telemetry.fleet import main as jax_fleet_main
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import TelemetryConfig, config_from_dict
from attackfl_tpu_torch.training.engine import Simulator

REPO = pathlib.Path(__file__).resolve().parent.parent
YAML = ("server: {num-round: 3, clients: 3, mode: fedavg, model: TransformerModel,\n"
        "         data-name: ICU, train-size: 128, test-size: 64, random-seed: 1,\n"
        "         data-distribution: {num-data-range: [16, 24]}}\n"
        "learning: {epoch: 1, batch-size: 16}\n"
        "tpu: {local-backend: pallas}\n")


def _yaml(tmp_path, rounds: int = 3) -> str:
    path = tmp_path / f"job{rounds}.yaml"
    path.write_text(YAML.replace("num-round: 3", f"num-round: {rounds}"))
    return str(path)


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _wait_for(predicate, timeout: float = 120.0, message: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {message}")


def _serve(spool, *flags) -> tuple[subprocess.Popen, str]:
    os.makedirs(spool, exist_ok=True)
    log = open(os.path.join(spool, "serve.log"), "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "attackfl_tpu_torch", "serve", "--spool", str(spool), "--port",
         "0", "--worker-backoff", "0.05", "--device", "cpu", *flags],
        cwd=str(REPO), env=_env(), stdout=log, stderr=subprocess.STDOUT)
    log.close()

    def up():
        if proc.poll() is not None:
            with open(os.path.join(spool, "serve.log")) as fh:
                raise AssertionError(f"serve exited {proc.returncode}: {fh.read()[-2000:]}")
        try:
            with open(os.path.join(spool, "service.json")) as fh:
                disc = json.load(fh)
        except (OSError, ValueError):
            return None
        return disc["url"] if disc.get("pid") == proc.pid else None

    return proc, _wait_for(up, message="the daemon's discovery file")


def _stop(proc) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _reference(tmp_path, rounds: int) -> dict:
    directory = tmp_path / f"reference{rounds}"
    cfg = config_from_dict({"server": {"num-round": rounds, "clients": 3, "mode": "fedavg",
                                       "model": "TransformerModel", "data-name": "ICU",
                                       "train-size": 128, "test-size": 64, "random-seed": 1,
                                       "data-distribution": {"num-data-range": [16, 24]}},
                            "learning": {"epoch": 1, "batch-size": 16},
                            "tpu": {"local-backend": "pallas"}})
    sim = Simulator(cfg.replace(log_path=str(directory), checkpoint_dir=str(directory),
                                telemetry=TelemetryConfig(enabled=False)), device="cpu")
    sim.run(verbose=False)
    sim.close()
    return torch.load(directory / "TransformerModel.pth", weights_only=True)


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_serve_and_the_job_commands(tmp_path, capsys):
    spool = tmp_path / "spool"
    proc, url = _serve(spool, "--max-workers", "1")
    try:
        rc, out = _run(cli.main, ["job", "submit", "--spool", str(spool), "--config",
                                  _yaml(tmp_path, 40), "--name", "long"])
        assert rc == 0
        long_id = out.strip()
        rc, out = _run(cli.main, ["job", "submit", "--url", url, "--config", _yaml(tmp_path),
                                  "--name", "short", "--rounds", "2", "--priority", "low"])
        short_id = out.strip()
        rc, out = _run(cli.main, ["job", "submit", "--url", url, "--config", _yaml(tmp_path),
                                  "--name", "dropped"])
        dropped = out.strip()
        assert rc == 0 and len({long_id, short_id, dropped}) == 3
        _wait_for(lambda: json.loads(_run(cli.main, ["job", "status", long_id, "--url", url])[1])
                  ["state"] == "running", message="the long job running")
        rc, out = _run(cli.main, ["job", "cancel", dropped, "--url", url])
        assert rc == 0 and json.loads(out) == {"job_id": dropped, "outcome": "cancelled"}
        rc, out = _run(cli.main, ["job", "wait", short_id, "--url", url, "--timeout", "120",
                                  "--interval", "0.1"])
        assert rc == 0 and json.loads(out)["state"] == "done"
        rc, out = _run(cli.main, ["job", "wait", long_id, "--url", url, "--timeout", "120",
                                  "--interval", "0.1"])
        payload = json.loads(out)
        assert rc == 0 and payload["state"] == "done"
        assert payload["result"] == {"completed": 40, "target": 40, "ok_rounds": 40}
        assert _run(cli.main, ["job", "wait", "nope", "--url", url])[0] == 2
        rc, ours = _run(cli.main, ["job", "list", "--url", url])
        assert rc == 0 and _run(jax_job_main, ["list", "--url", url]) == (0, ours)
        assert [line.split()[1] for line in ours.splitlines()] == ["done", "done", "cancelled"]
        rc, out = _run(jax_job_main, ["status", short_id, "--url", url])
        assert rc == 0 and json.loads(out)["num_rounds"] == 2
        capsys.readouterr()
        rc, out = _run(cli.main, ["watch", url, "--schedule", "--once"])
        assert rc == 0 and out.startswith("[watch] sched queue=0 backlog=")
        # the scheduler releases a slot just after its job's status says done
        _wait_for(lambda: cli._http_get_json(url + "/schedule")[1]["running_jobs"] == 0,
                  message="the slots' release")
        rc, out = _run(cli.main, ["watch", url, "--fleet", "--once"])
        assert rc == 0 and _run(jax_watch_main, [url, "--fleet", "--once"]) == (0, out)
        assert out.startswith("[watch] fleet queue=0 running=0") and "  slo: p95[" in out
        assert cli.main(["watch", url, "--schedule", "--once"]) == 0
    finally:
        assert _stop(proc) == 0
    events = [json.loads(line) for line in open(spool / "service.events.jsonl")]
    assert [e["action"] for e in events if e["kind"] == "service"][-3:] == [
        "draining", "drained", "stopped"]
    for flags in ([], ["--json"]):
        rc, ours = _run(cli.main, ["fleet", "report", str(spool), *flags])
        assert rc == 0 and _run(jax_fleet_main, ["report", str(spool), *flags]) == (0, ours)
    ledger = json.loads(ours)["ledger"]
    assert ledger["books_close"] is True and ledger["slots"] == 1
    # the long and the short job ran; the cancelled one never held a slot
    assert [row["end_action"] for row in ledger["jobs"]] == ["completed", "completed"]


def test_kill_dash_nine_recovery_bit_identical(tmp_path):
    """A daemon SIGKILLed mid-run with one running and two queued jobs, one
    queued entry torn after the kill: the restarted daemon's replay
    requeues both, every job ends bit-equal to a standalone port run, and
    SIGTERM drains it with exit 0."""
    spool = tmp_path / "spool"
    rounds = (30, 3, 3)
    proc, url = _serve(spool)
    try:
        jobs = [_run(cli.main, ["job", "submit", "--spool", str(spool), "--config",
                                _yaml(tmp_path, r), "--name", f"j{i}"])[1].strip()
                for i, r in enumerate(rounds)]
        _wait_for((spool / "jobs" / jobs[0] / "manifest.json").exists,
                  message="job 0's first checkpoint")
        proc.kill()
        proc.wait(timeout=30)
        status = spool / "queue" / f"{jobs[1]}.status.json"
        status.write_bytes(status.read_bytes()[: status.stat().st_size // 2])
        proc, url = _serve(spool)
        for job_id in jobs:
            rc, out = _run(cli.main, ["job", "wait", job_id, "--spool", str(spool),
                                      "--timeout", "180", "--interval", "0.1"])
            assert rc == 0, out
    finally:
        assert _stop(proc) == 0
    for job_id, r in zip(jobs, rounds):
        final = torch.load(spool / "jobs" / job_id / "TransformerModel.pth", weights_only=True)
        assert _same_bits(final, _reference(tmp_path, r)), job_id
    events = [json.loads(line) for line in open(spool / "service.events.jsonl")]
    replayed = [e for e in events if e["kind"] == "service" and e["action"] == "replayed"]
    assert replayed and replayed[0]["torn_entries"] >= 1
    reasons = {e["job_id"]: e["reason"] for e in events
               if e["kind"] == "job" and e["action"] == "requeued"}
    assert reasons[jobs[0]] == "interrupted" and reasons[jobs[1]] == "status_torn"


def test_serve_without_device_cpu_refuses_here(tmp_path):
    """The daemon's device defaults to the card: without one it exits non-zero
    naming the missing device and never publishes its discovery file."""
    spool = tmp_path / "spool"
    result = subprocess.run(
        [sys.executable, "-m", "attackfl_tpu_torch", "serve", "--spool", str(spool), "--port",
         "0"], cwd=str(REPO), env=_env(), capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "no CUDA device is visible" in result.stderr
    assert not (spool / "service.json").exists()
