"""``python -m attackfl_tpu_torch serve`` (the daemon) and ``... job``
(the client): the port's copy of ``attackfl_tpu/service/cli.py``.

``serve`` promotes the CLI into the persistent run service: it reads the
config's ``service:`` section for defaults (every flag overrides), binds
the control plane (``--port 0`` = ephemeral, the ACTUAL port is printed
and published in ``<spool>/service.json``), replays the queue (crash
recovery), and then serves until SIGTERM/SIGINT — which triggers the
graceful drain: in-flight rounds finish, unfinished jobs are requeued
for the next daemon, and the process exits 0.  Every job runs on the
device ``--device`` names, ``cuda`` unless ``cpu`` is asked for; without
a card the daemon refuses to start rather than run anywhere else.

``job`` talks to a live service over HTTP (or reads the spool's
discovery file to find it) without importing torch: ``submit`` posts a
config (YAML file or the service's base config) and prints the job id,
``list``/``status`` render the queue, ``cancel`` stops a job at the next
round boundary, ``wait`` polls until a terminal state (the smoke
script's building block).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import urllib.error
import urllib.request

from attackfl_tpu_torch.telemetry.console import print_with_color

TERMINAL_STATES = ("done", "failed", "cancelled")


def serve_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch serve",
        description="Persistent run service: durable job queue + "
                    "supervised workers + HTTP control plane.")
    parser.add_argument("--spool", type=str, default=None,
                        help="spool directory (queue + per-job dirs + "
                             "shared ledger + service events); default: "
                             "service.spool-dir from --config, else "
                             "./service-spool")
    parser.add_argument("--config", type=str, default=None,
                        help="base config.yaml: its service: section "
                             "seeds the flags below; its other sections "
                             "are the default job config for submissions "
                             "that send none")
    parser.add_argument("--port", type=int, default=None,
                        help="control-plane port (0 = ephemeral; the "
                             "actual port is printed and written to "
                             "<spool>/service.json)")
    parser.add_argument("--host", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device every job runs on: cuda (default) or cpu")
    parser.add_argument("--max-workers", type=int, default=None,
                        help="max concurrent runs (admission control)")
    parser.add_argument("--queue-depth", type=int, default=None,
                        help="max queued+running jobs; submission beyond "
                             "this is an explicit 429 rejection")
    parser.add_argument("--worker-retries", type=int, default=None,
                        help="restarts (with exponential backoff) before "
                             "a crashing job is marked failed")
    parser.add_argument("--worker-backoff", type=float, default=None,
                        metavar="SECONDS", help="backoff base (doubles "
                        "per restart, capped)")
    parser.add_argument("--inject-faults", type=str, default=None,
                        metavar="PLAN",
                        help="service chaos plan (kinds: worker_death "
                             "queue_torn submit_flood preempt_storm "
                             "estimate_skew; same grammar as "
                             "run --inject-faults)")
    parser.add_argument("--no-run-monitors", action="store_true",
                        help="skip the per-run monitor (stall watchdog + "
                             "per-run /metrics on ephemeral ports)")
    parser.add_argument("--compile-cache", type=str, default=None,
                        metavar="DIR", help="compile-cache-dir, accepted for "
                        "the JAX package's schema; the port compiles no "
                        "programs (its kernels' libraries are cached under "
                        "attackfl_tpu_torch/_build)")
    parser.add_argument("--drain-grace", type=float, default=None,
                        metavar="SECONDS",
                        help="SIGTERM: how long the drain waits for "
                             "in-flight rounds before exiting anyway "
                             "(the next daemon's replay recovers)")
    parser.add_argument("--no-scheduler", action="store_true",
                        help="disable the preemptive scheduler: restore "
                             "the oldest-first dispatch loop")
    parser.add_argument("--aging-rate", type=float, default=None,
                        metavar="PTS_PER_S",
                        help="scheduler aging: effective-priority points "
                             "per waiting second (starvation bound "
                             "scales as 1/rate)")
    parser.add_argument("--shed-horizon", type=float, default=None,
                        metavar="SECONDS",
                        help="shed submissions whose predicted backlog "
                             "exceeds this (429 + priced retry-after); "
                             "0 = never shed")
    parser.add_argument("--once", action="store_true",
                        help="exit once the queue is empty and idle "
                             "(batch mode / smoke tests) instead of "
                             "serving forever")
    args = parser.parse_args(argv)

    from attackfl_tpu_torch.config import Config, load_config

    base_raw: dict = {}
    if args.config:
        import yaml

        with open(args.config) as fh:
            base_raw = yaml.safe_load(fh) or {}
        cfg = load_config(args.config)
    else:
        cfg = Config()
    svc = cfg.service
    spool = args.spool or svc.spool_dir or "./service-spool"
    drain_grace = (svc.drain_grace_seconds if args.drain_grace is None
                   else args.drain_grace)
    fault_plan = ()
    if args.inject_faults is not None:
        from attackfl_tpu_torch.faults.plan import parse_fault_plan

        fault_plan = parse_fault_plan(args.inject_faults)

    from attackfl_tpu_torch.service.daemon import RunService

    service = RunService(
        spool,
        port=svc.port if args.port is None else args.port,
        host=args.host or svc.host,
        max_workers=(svc.max_workers if args.max_workers is None
                     else args.max_workers),
        queue_depth=(svc.queue_depth if args.queue_depth is None
                     else args.queue_depth),
        worker_retries=(svc.worker_retries if args.worker_retries is None
                        else args.worker_retries),
        worker_backoff=(svc.worker_backoff if args.worker_backoff is None
                        else args.worker_backoff),
        worker_backoff_cap=svc.worker_backoff_cap,
        run_monitors=svc.run_monitors and not args.no_run_monitors,
        fault_plan=fault_plan,
        compile_cache_dir=(args.compile_cache
                           or os.environ.get("ATTACKFL_COMPILE_CACHE")
                           or cfg.compile_cache_dir),
        base_config=base_raw,
        scheduler=svc.scheduler and not args.no_scheduler,
        sched_aging_rate=(svc.sched_aging_rate if args.aging_rate is None
                          else args.aging_rate),
        sched_min_runtime=svc.sched_min_runtime,
        sched_shed_horizon=(svc.sched_shed_horizon
                            if args.shed_horizon is None
                            else args.shed_horizon),
        sched_breaker_attempts=svc.sched_breaker_attempts,
        sched_default_cost=svc.sched_default_cost,
        device=args.device,
    )
    service.start()
    print_with_color(
        f"[serve] http://localhost:{service.port} "
        "(/healthz /jobs /submit /cancel /metrics /runs /schedule) — "
        f"spool {spool} — device {service.device} — submit with "
        "`python -m attackfl_tpu_torch job submit`", "cyan")

    draining = {"flag": False}

    def on_signal(signum, frame):
        # SIGTERM/SIGINT: graceful drain — finish in-flight rounds,
        # checkpoint, requeue, exit (kill -9 is the replay's job)
        draining["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        while not draining["flag"]:
            if args.once and service_idle(service):
                break
            time.sleep(0.2)
    finally:
        if draining["flag"]:
            print_with_color(
                "[serve] drain requested: finishing in-flight rounds, "
                "requeueing the rest", "yellow")
            service.drain(timeout=drain_grace)
        service.close()
    return 0


def service_idle(service) -> bool:
    """True when nothing is running and nothing is claimable."""
    code, payload = service.health()
    jobs = payload.get("jobs", {})
    return (payload.get("active_runs", 0) == 0
            and jobs.get("queued", 0) == 0
            and jobs.get("running", 0) == 0)


# ---------------------------------------------------------------------------
# job client (imports no torch)
# ---------------------------------------------------------------------------


def _discover_url(args) -> str:
    if args.url:
        return args.url.rstrip("/")
    if args.spool:
        path = os.path.join(args.spool, "service.json")
        try:
            with open(path) as fh:
                return str(json.load(fh)["url"]).rstrip("/")
        except (OSError, ValueError, KeyError):
            raise SystemExit(
                f"no service discovery file at {path}; is the daemon "
                "running? (pass --url explicitly otherwise)")
    return "http://127.0.0.1:8781"


def _request(url: str, method: str = "GET", body: dict | None = None,
             timeout: float = 10.0) -> tuple[int, dict]:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except ValueError:
            return e.code, {"error": f"http {e.code}"}


def job_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch job",
        description="Run-service client: submit/list/status/cancel/wait "
                    "(talks HTTP to a live `python -m attackfl_tpu_torch "
                    "serve`).")
    parser.add_argument("command",
                        choices=["submit", "list", "status", "cancel",
                                 "wait"])
    parser.add_argument("job_id", nargs="?", default=None,
                        help="job id (status/cancel/wait)")
    parser.add_argument("--url", type=str, default=None,
                        help="service base URL (printed at serve start)")
    parser.add_argument("--spool", type=str, default=None,
                        help="spool dir: reads <spool>/service.json for "
                             "the URL instead of --url")
    parser.add_argument("--config", type=str, default=None,
                        help="submit: job config.yaml (omitted = the "
                             "service's base config)")
    parser.add_argument("--rounds", type=int, default=None,
                        help="submit: round-count override")
    parser.add_argument("--name", type=str, default=None,
                        help="submit: human-readable job label")
    parser.add_argument("--priority", type=str, default=None,
                        choices=["high", "normal", "low"],
                        help="submit: scheduler priority class "
                             "(default normal)")
    parser.add_argument("--timeout", type=int, default=600,
                        help="wait: seconds before giving up (exit 3)")
    parser.add_argument("--interval", type=float, default=0.5,
                        help="wait: poll period in seconds")
    args = parser.parse_args(argv)
    base = _discover_url(args)

    if args.command == "submit":
        spec: dict = {}
        if args.config:
            import yaml

            with open(args.config) as fh:
                spec["config"] = yaml.safe_load(fh) or {}
        if args.rounds is not None:
            spec["num_rounds"] = args.rounds
        if args.name:
            spec["name"] = args.name
        if args.priority:
            spec["priority"] = args.priority
        code, payload = _request(base + "/submit", "POST", spec)
        if code != 200:
            retry = payload.get("retry_after_seconds")
            hint = f" (retry in ~{retry}s)" if retry is not None else ""
            print(f"submit rejected ({code}): {payload.get('error')}{hint}",
                  file=sys.stderr)
            return 1
        print(payload["job_id"])
        return 0

    if args.command == "list":
        code, payload = _request(base + "/jobs")
        for job in payload.get("jobs", []):
            rounds = job.get("num_rounds") or "-"
            print(f"{job['job_id']}  {job['state']:<9}  rounds={rounds}  "
                  f"attempts={job.get('attempts', 0)}  "
                  f"{job.get('name', '')}".rstrip())
        return 0

    if args.job_id is None:
        print(f"{args.command} needs a job id", file=sys.stderr)
        return 2

    if args.command == "status":
        code, payload = _request(base + f"/status?job={args.job_id}")
        print(json.dumps(payload, indent=1))
        return 0 if code == 200 else 1

    if args.command == "cancel":
        code, payload = _request(base + f"/cancel?job={args.job_id}",
                                 "POST")
        print(json.dumps(payload))
        return 0 if code == 200 else 1

    # wait: poll until terminal (exit 0 done / 1 failed-cancelled /
    # 2 unknown job / 3 timeout)
    deadline = time.monotonic() + args.timeout
    interval = args.interval
    while True:
        code, payload = _request(base + f"/status?job={args.job_id}")
        if code == 404:
            print(payload.get("error", "no such job"), file=sys.stderr)
            return 2
        state = payload.get("state")
        if state in TERMINAL_STATES:
            print(json.dumps(payload, indent=1))
            return 0 if state == "done" else 1
        if time.monotonic() > deadline:
            print(f"timed out waiting for {args.job_id} "
                  f"(state {state})", file=sys.stderr)
            return 3
        time.sleep(min(max(interval, 0.05), 5))
