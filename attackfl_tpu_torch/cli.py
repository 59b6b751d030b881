"""``python -m attackfl_tpu_torch``: the port's launchers, mirroring
``python -m attackfl_tpu`` (``attackfl_tpu/cli.py``).

The reference is started as one ``server.py`` and N ``client.py``
processes (README.md:91-143).  Here the federation runs in one process,
and the same workflow goes through a file rendezvous, the JAX package's
byte for byte: each ``client`` writes a registration (client id and
attack flags) into ``.registrations/`` beside the config and exits;
``server`` waits until ``server.clients`` registrations are there, turns
the attacking ones into the run's attackers, and runs the federation on
the card.  ``server --no-wait``, and ``run``, which is the same, skip the
rendezvous and take the attackers from the config's ``attack-clients``
section.  With ``--coordinator HOST:PORT --num-processes N --process-id
I`` (``--no-wait`` only) the run is one of N processes, each started alike,
that join a ``torch.distributed`` group at process 0's address and run the
federation SPMD over one client mesh of every process's devices
(``parallel/mesh.py``).

``metrics`` summarizes a run's ``events.jsonl``, ``watch`` polls a live
run's monitor (``--monitor``), a run service's scheduler (``--schedule``)
or its SLO gauges (``--fleet``), ``hotspots`` mines a run's profiling
windows and ``cost`` prices a config from the ledger, as the JAX
package's commands do.  ``serve`` is the run service, a daemon that runs
submitted jobs on the card through the scheduler, ``job`` its HTTP client
and ``fleet`` the observatory over its spool.  ``audit`` checks the
port's invariants (the AST rules, the committed event files, the round
programs), ``ledger`` queries and gates the cross-run records and
``science`` ranks a sweep's defenses, with the JAX package's output and
exit codes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import uuid

from attackfl_tpu_torch.telemetry.console import print_with_color

REG_DIR = ".registrations"

_USAGE = """usage: python -m attackfl_tpu_torch <command> [options]

commands:
  server   wait for `server.clients` registrations beside the config, then
           run the federation with their attackers (--config PATH,
           --device cuda|cpu, --no-wait, --rounds N, --pipeline,
           --pipeline-depth K|auto, --resume, --checkpoint-async,
           --inject-faults PLAN, --validation-every K, --validation-async,
           --compile-cache DIR, --monitor, --monitor-port N, --numerics,
           --hotspots A:B (a torch.profiler window over rounds A..B, traces
           under <log_path>/profile), --profile-rounds A:B, --coordinator
           HOST:PORT with --num-processes N and --process-id I (with
           --no-wait: one of N processes over one client mesh))
  client   register one client for the server (--config PATH, --attack
           [True], --attack_mode MODE, --attack_round N, --attack_args X..)
  run      server --no-wait: attackers from the config's attack-clients
  metrics  summarize a run's events.jsonl (PATH, --run-id ID, --all,
           --json, --forensics, --numerics, --programs, --merge: a run
           directory's events.<i>.jsonl or a service spool's streams)
  watch    poll a live run's monitor (URL, --interval S, --once), or a run
           service's scheduler (--schedule) or SLO gauges (--fleet)
  serve    the run service: a durable job queue, supervised workers on one
           device, the preemptive scheduler and an HTTP control plane
           (--spool DIR, --config PATH, --port N, --device cuda|cpu,
           --max-workers N, --queue-depth N, --worker-retries N,
           --worker-backoff S, --inject-faults PLAN, --no-run-monitors,
           --drain-grace S, --no-scheduler, --aging-rate X, --shed-horizon S,
           --once); SIGTERM drains
  job      the run service's client: submit [--config PATH] [--rounds N]
           [--name S] [--priority high|normal|low], list, status ID,
           cancel ID, wait ID [--timeout S] (--spool DIR or --url URL)
  hotspots mine a run's profiling windows: show [DIR] [--json] [--top K],
           diff A B [--json] [--hostbound-rise X] [--share-drift X]
  cost     the cost model: estimate --config PATH [--rounds N] [--dir D]
           [--device cuda|cpu] [--matrix] [--no-compile] [--json]; validate
           [--dir D] [--window N] [--max-median-factor X] [--json]
  matrix   the scenario matrix: run --config PATH [--attacks A,..]
           [--defenses D,..] [--seeds S,..] [--rounds N] [--chunk K]
           [--sweep-dir DIR] [--sweep-id ID] [--resume] [--device cuda|cpu]
           [--mesh] (the cell axis over the client mesh's devices);
           status [--dir D] [--sweep-id ID] [--json]
  audit    the AST rules, the committed event files, the round programs
           run once under a dispatch mode and the transform-safety auditor
           (the damage objectives' gradients, the per-defense dataflow
           table) (--json, --skip-programs, --retrace, --rules R..,
           --device cuda|cpu, --grad, --skip-grad, --skip-sharded)
  ledger   the cross-run ledger: list [--sweep ID] [--json], show ID,
           compare A [B], regress [ID] [--against ID] [--sweeps OLD NEW]
           (exit 0 pass, 1 regression, 2 nothing to compare), import
           FILE.. (--dir D)
  science  a sweep's robustness leaderboard: leaderboard [--outcomes],
           report [--out PATH], diff [OLD NEW] [--gate] (--dir D)
  fleet    the fleet observatory over a service spool: report [SPOOL]
           [--json] (the SLO gauges and the per-tenant device-time ledger,
           whose books must close), trace [SPOOL] [--out PATH]
"""


def _registration_dir(base: str) -> str:
    path = os.path.join(base, REG_DIR)
    os.makedirs(path, exist_ok=True)
    return path


def client_main(argv=None) -> int:
    """Reference client flags (client.py:19-38) -> a registration file
    (JAX cli.py:56-97)."""
    parser = argparse.ArgumentParser(prog="python -m attackfl_tpu_torch client",
                                     description="attackfl_tpu_torch client launcher")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--device", type=str, required=False,
                        help="accepted for parity; unused")
    # the bare `--attack` and the reference's `--attack True`: client.py:21
    # takes argparse type=bool, which reads ANY string, "False" too, as
    # true, so the text is parsed instead
    parser.add_argument("--attack", nargs="?", const=True, default=False,
                        type=lambda s: str(s).strip().lower() in ("true", "1", "yes"))
    parser.add_argument("--attack_mode", type=str,
                        choices=["Random", "Min-Max", "Min-Sum", "Opt-Fang", "LIE"])
    parser.add_argument("--attack_round", type=int)
    parser.add_argument("--attack_args", type=float, nargs="+")
    args = parser.parse_args(argv)

    if args.attack and not args.attack_mode:
        print("Error: --attack_mode is required when --attack is True.")
        return 1
    if args.attack and not args.attack_round:
        print("Error: --attack_round is required when --attack is True.")
        return 1

    client_id = str(uuid.uuid4())
    reg = {
        "client_id": client_id,
        "attack": bool(args.attack),
        "attack_mode": args.attack_mode,
        "attack_round": args.attack_round,
        "attack_args": args.attack_args or [],
    }
    reg_dir = _registration_dir(os.path.dirname(os.path.abspath(args.config)))
    path = os.path.join(reg_dir, f"{client_id}.json")
    tmp = path + ".tmp"          # published whole: the server polls the directory
    with open(tmp, "w") as fh:
        json.dump(reg, fh)
    os.replace(tmp, path)
    print_with_color("[>>>] Client sending registration message to server...", "red")
    print(f"Client ID: {client_id}")
    print(f"Attack: {reg['attack']}, Mode: {reg['attack_mode']}")
    return 0


def _collect_registrations(cfg, base: str, timeout: float = 600.0) -> list[dict]:
    """Wait for ``cfg.total_clients`` registrations under ``base``, read in
    sorted file-name order; then empty the directory (the reference's
    queue hygiene, delete_old_queues) and return the first
    ``total_clients``.  TimeoutError after ``timeout`` seconds."""
    reg_dir = _registration_dir(base)
    print_with_color(f"Server is waiting for {cfg.total_clients} clients.", "green")
    deadline = time.time() + timeout
    while True:
        regs = []
        for name in sorted(os.listdir(reg_dir)):
            if name.endswith(".json"):
                try:
                    with open(os.path.join(reg_dir, name)) as fh:
                        regs.append(json.load(fh))
                except (json.JSONDecodeError, OSError):
                    continue         # mid-write or gone: the next poll reads it
        if len(regs) >= cfg.total_clients:
            for name in os.listdir(reg_dir):
                os.unlink(os.path.join(reg_dir, name))
            return regs[:cfg.total_clients]
        if time.time() > deadline:
            raise TimeoutError(f"only {len(regs)}/{cfg.total_clients} clients registered")
        time.sleep(0.5)


def _attacks_from_registrations(regs: list[dict]) -> tuple:
    """One attack spec per attacking registration, for client index i (its
    position in the sorted registrations)."""
    from attackfl_tpu_torch.config import AttackSpec

    return tuple(AttackSpec(mode=reg["attack_mode"], client_ids=(i,),
                            attack_round=int(reg["attack_round"] or 1),
                            args=tuple(reg.get("attack_args") or []))
                 for i, reg in enumerate(regs) if reg.get("attack"))


def server_main(argv=None) -> int:
    """The server (JAX cli.py:137-310): every flag of JAX's sets the
    Config field its YAML key sets; the port's engine refuses what it
    cannot run yet, naming the ROADMAP item."""
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch server",
        description="Federated poisoning simulation on one GPU (PyTorch port).")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--no-wait", action="store_true",
                        help="skip the client rendezvous; attackers come from the config")
    parser.add_argument("--rounds", type=int, default=None, help="override num-round")
    # --- round-executor and persistence overrides (the config's server: section) ---
    parser.add_argument("--pipeline", action="store_true",
                        help="depth-k pipelined round executor: round N resolves while "
                             "the next rounds run on the card (server.pipeline)")
    parser.add_argument("--pipeline-depth", type=str, default=None, metavar="K",
                        help="pipeline depth, 0..max or 'auto' (server.pipeline-depth); "
                             "implies --pipeline")
    parser.add_argument("--checkpoint-async", action="store_true",
                        help="background checkpoint writer: serialize, write and fsync "
                             "off the round loop (server.checkpoint-async)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint directory's manifest.json: "
                             "the newest valid entry wins, a torn one falls back to the "
                             "one before, round numbering continues (server.resume)")
    parser.add_argument("--inject-faults", type=str, default=None, metavar="PLAN",
                        help="deterministic fault plan, e.g. 'nan_storm@3:clients=0,1;"
                             "ckpt_write_error@2:count=2;writer_death@4' (kinds: nan_storm "
                             "dropout ckpt_write_error ckpt_torn writer_death monitor_stall; "
                             "the config's `faults:` section takes the same entries as "
                             "mappings)")
    parser.add_argument("--validation-every", type=int, default=None, metavar="K",
                        help="validate every K-th broadcast (server.validation-every; "
                             "default 1)")
    parser.add_argument("--validation-async", action="store_true",
                        help="validate round N while round N+1 trains; the result lands "
                             "in the round's history entry and does not gate the round "
                             "(server.validation-async)")
    parser.add_argument("--compile-cache", type=str, default=None, metavar="DIR",
                        help="compile-cache-dir, accepted for the JAX package's schema; "
                             "the port compiles no programs (its kernels' libraries are "
                             "cached under attackfl_tpu_torch/_build)")
    # --- observability overrides (the config's telemetry: section; ROADMAP.md item 16) ---
    parser.add_argument("--monitor", action="store_true",
                        help="live health endpoint and stall watchdog (telemetry.monitor)")
    parser.add_argument("--monitor-port", type=int, default=None,
                        help="monitor port; implies --monitor (telemetry.monitor-port)")
    parser.add_argument("--profile-rounds", type=str, default=None, metavar="A:B",
                        help="profile rounds A..B (telemetry.profile-rounds)")
    parser.add_argument("--hotspots", type=str, default=None, metavar="A:B",
                        help="hotspot window over rounds A..B (telemetry.hotspots)")
    parser.add_argument("--numerics", action="store_true",
                        help="device-side per-round numerics rows (telemetry.numerics)")
    # --- multi-host scale-out: one process of N over one client mesh ---
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 (needs --no-wait)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    args = parser.parse_args(argv)

    if args.coordinator:
        if not args.no_wait:
            # the file rendezvous is host-local: with N hosts the attackers
            # must come from the shared config
            print("Error: --coordinator requires --no-wait "
                  "(declare attackers in config's attack-clients).")
            return 1
        import torch.distributed as dist

        from attackfl_tpu_torch.parallel.mesh import distributed_init

        try:
            distributed_init(args.coordinator, args.num_processes, args.process_id)
        except dist.DistError as e:
            print(f"Error: process {args.process_id} of {args.num_processes} could not join "
                  f"the process group at {args.coordinator}: {e}")
            return 1

    from attackfl_tpu_torch.config import load_config

    cfg = load_config(args.config)
    overrides: dict = {}
    if args.monitor:
        overrides["monitor"] = True
    if args.monitor_port is not None:
        overrides["monitor"] = True
        overrides["monitor_port"] = args.monitor_port
    if args.profile_rounds is not None:
        overrides["profile_rounds"] = args.profile_rounds
    if args.hotspots is not None:
        overrides["hotspots"] = args.hotspots
    if args.numerics:
        overrides["numerics"] = True
    if overrides:
        cfg = cfg.replace(telemetry=dataclasses.replace(cfg.telemetry, **overrides))
    perf: dict = {}
    if args.pipeline:
        perf["pipeline"] = True
    if args.pipeline_depth is not None:
        perf["pipeline"] = True
        perf["pipeline_depth"] = args.pipeline_depth
    if args.checkpoint_async:
        perf["checkpoint_async"] = True
    if args.resume:
        perf["resume"] = True
    if args.inject_faults is not None:
        from attackfl_tpu_torch.faults.plan import parse_fault_plan

        perf["faults"] = parse_fault_plan(args.inject_faults)
    if args.validation_every is not None:
        perf["validation_every"] = args.validation_every
    if args.validation_async:
        perf["validation_async"] = True
    if args.compile_cache is not None:
        perf["compile_cache_dir"] = args.compile_cache
    if perf:
        cfg = cfg.replace(**perf)

    if not args.no_wait:
        regs = _collect_registrations(cfg, os.path.dirname(os.path.abspath(args.config)))
        print_with_color("All clients are connected. Sending notifications.", "green")
        cfg = cfg.replace(attacks=_attacks_from_registrations(regs))

    from attackfl_tpu_torch.training.engine import Simulator

    # a client mesh over the visible devices (tpu.num-devices), as JAX's
    # run builds one (cli.py:298): one card gives a one-device mesh, and
    # with --coordinator the mesh spans every process's devices
    try:
        sim = Simulator(cfg, device=args.device, use_mesh=True)
        try:
            _, history = sim.run(num_rounds=args.rounds)
        finally:
            sim.close()
    finally:
        if args.coordinator:
            dist.destroy_process_group()
    ok_rounds = sum(1 for h in history if h["ok"])
    print_with_color(f"Finished: {ok_rounds} successful rounds.", "green")
    return 0


def run_main(argv=None) -> int:
    """``run``: the launcher without the rendezvous (JAX cli.py:313-317)."""
    args = list(sys.argv[1:] if argv is None else argv)
    return server_main(["--no-wait", *args])


def metrics_main(argv=None) -> int:
    """``metrics``: summarize a run's events.jsonl (``--forensics`` for
    the defense's TPR/FPR, ``--numerics`` for the device-side round
    metrics; JAX cli.py:320-326)."""
    from attackfl_tpu_torch.telemetry.summary import main as summary_main

    return summary_main(list(sys.argv[1:] if argv is None else argv))


def _http_get_json(url: str, timeout: float = 5.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode() or "{}")


def _http_get_text(url: str, timeout: float = 5.0) -> tuple[int, str]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _parse_prom(text: str) -> dict:
    """Minimal Prometheus text-exposition parser: ``{name{labels} ->
    float}`` with the raw label string kept as part of the key (enough
    to read back the gauges our own ``metrics_text`` writes)."""
    gauges: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            gauges[name] = float(value)
        except ValueError:
            continue
    return gauges


def _watch_backoff(failures: int, interval: float, cap: float = 60.0) -> float:
    """Capped exponential backoff for unreachable monitors: the normal
    poll period for the first miss, doubling per consecutive miss, never
    above ``cap``.  A service restart (seconds of connection-refused)
    costs a few quick retries instead of a crash or a minute-long gap."""
    return min(interval * (2 ** max(failures - 1, 0)), cap)


def _watch_schedule(base: str, args) -> int:
    """``watch --schedule``: poll a run service's ``/schedule`` endpoint
    (JAX cli.py:368-418): one line a poll with the queue depth, predicted
    backlog and totals, and a per-job table whenever the queue's
    composition changes.  An unreachable service gets the monitor
    poller's capped backoff."""
    import http.client
    import urllib.error

    failures = 0
    last_shape: tuple | None = None
    while True:
        try:
            _, snap = _http_get_json(base + "/schedule")
        except urllib.error.HTTPError as e:
            print(f"[watch] /schedule -> http {e.code} (scheduler disabled?)",
                  file=sys.stderr)
            return 2
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError) as e:
            failures += 1
            delay = _watch_backoff(failures, args.interval, args.max_backoff)
            print(f"[watch] {base} unreachable: {e} "
                  f"(retry {failures} in {delay:.1f}s)", file=sys.stderr)
            if args.once:
                return 2
            time.sleep(delay)
            continue
        failures = 0
        jobs = snap.get("jobs") or []
        print(f"[watch] sched queue={snap.get('queue_depth')} "
              f"backlog={snap.get('backlog_seconds', 0):.1f}s "
              f"max_wait={snap.get('max_wait_seconds', 0):.1f}s "
              f"preempted={snap.get('preempted_total')} "
              f"shed={snap.get('shed_total')} "
              f"broken={snap.get('circuit_broken_total')}", flush=True)
        shape = tuple((j.get("job_id"), j.get("state")) for j in jobs)
        if jobs and shape != last_shape:
            last_shape = shape
            for job in jobs:
                print(f"[watch]   {job.get('job_id')} "
                      f"{job.get('state'):<7} {job.get('priority'):<6} "
                      f"eff={job.get('effective_priority')} "
                      f"rem~{job.get('predicted_remaining_seconds')}s "
                      f"preempts={job.get('preemptions')} "
                      f"wait={job.get('wait_seconds')}s", flush=True)
        if args.once:
            return 0
        time.sleep(args.interval)


def _watch_fleet(base: str, args) -> int:
    """``watch --fleet``: poll a run service's Prometheus ``/metrics``
    endpoint (JAX cli.py:420-478) and render the scheduler and SLO gauges
    one line per poll: queue depth, running jobs, per-priority p95 waits,
    preemption and shed rates.  Same capped backoff as every other
    watcher."""
    import http.client
    import urllib.error

    failures = 0
    while True:
        try:
            _, text = _http_get_text(base + "/metrics")
        except urllib.error.HTTPError as e:
            print(f"[watch] /metrics -> http {e.code}", file=sys.stderr)
            return 2
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError) as e:
            failures += 1
            delay = _watch_backoff(failures, args.interval,
                                   args.max_backoff)
            print(f"[watch] {base} unreachable: {e} "
                  f"(retry {failures} in {delay:.1f}s)", file=sys.stderr)
            if args.once:
                return 2
            time.sleep(delay)
            continue
        failures = 0
        gauges = _parse_prom(text)

        def g(name: str, default: float = 0.0) -> float:
            return gauges.get(name, default)

        line = (f"[watch] fleet queue={g('attackfl_sched_queue_depth'):.0f} "
                f"running={g('attackfl_sched_running_jobs'):.0f} "
                f"backlog={g('attackfl_sched_backlog_seconds'):.1f}s "
                f"preempted={g('attackfl_sched_preempted_total'):.0f} "
                f"shed={g('attackfl_sched_shed_total'):.0f}")
        slo_parts = []
        for name, value in sorted(gauges.items()):
            if name.startswith("attackfl_slo_queue_wait_p95_seconds{"):
                prio = name.split('priority="', 1)[-1].rstrip('"}')
                slo_parts.append(f"p95[{prio}]={value:.1f}s")
        if "attackfl_slo_preemption_rate" in gauges:
            slo_parts.append(
                f"preempt-rate={gauges['attackfl_slo_preemption_rate']}")
        if "attackfl_slo_shed_rate" in gauges:
            slo_parts.append(
                f"shed-rate={gauges['attackfl_slo_shed_rate']}")
        margin = gauges.get("attackfl_slo_starvation_bound_margin_seconds")
        if margin is not None:
            slo_parts.append(f"starv-margin={margin:.1f}s")
        if slo_parts:
            line += "  slo: " + " ".join(slo_parts)
        print(line, flush=True)
        if args.once:
            return 0
        time.sleep(args.interval)


def watch_main(argv=None) -> int:
    """``watch``: thin poller of a live run's monitor endpoint
    (``--monitor`` on run/server; JAX cli.py:474-637): prints each new
    round as it completes, with its numerics gauges and pipeline depth,
    and shouts when ``/healthz`` flips to stalled or degraded.

    Connection-refused / connection-reset (a monitor rebinding) is
    survived with capped exponential backoff: the poller retries rather
    than crashing mid-watch.  The round line carries the cost model's
    live utilization (``/programs``) and the latest window's host-bound
    fraction (``/hotspots``), and the client mesh's size and strategy
    (``mesh=``, JAX cli.py:612-618).  ``--schedule`` polls a run service's
    ``/schedule`` instead (:func:`_watch_schedule`), ``--fleet`` its
    Prometheus ``/metrics`` with the fleet's SLO gauges
    (:func:`_watch_fleet`)."""
    import http.client
    import urllib.error

    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch watch",
        description="Poll a running simulation's monitor endpoint.")
    parser.add_argument("url", nargs="?", default="http://127.0.0.1:8780",
                        help="monitor base URL (printed at run start)")
    parser.add_argument("--interval", type=float, default=5.0,
                        help="poll period in seconds (default 5)")
    parser.add_argument("--max-backoff", type=float, default=60.0,
                        help="cap for the unreachable-retry backoff "
                             "(default 60s)")
    parser.add_argument("--once", action="store_true",
                        help="single poll: exit 0 healthy, 1 stalled, "
                             "2 unreachable")
    parser.add_argument("--schedule", action="store_true",
                        help="watch a run service's /schedule endpoint "
                             "instead: queue depth, backlog vs horizon, "
                             "per-job effective priorities and "
                             "preemption/wait accounting")
    parser.add_argument("--fleet", action="store_true",
                        help="watch a run service's Prometheus /metrics "
                             "endpoint instead: scheduler gauges + the "
                             "fleet SLO gauges (per-priority p95 queue "
                             "wait, preemption/shed rates, starvation "
                             "margin)")
    args = parser.parse_args(argv)
    base = args.url.rstrip("/")
    if args.schedule:
        return _watch_schedule(base, args)
    if args.fleet:
        return _watch_fleet(base, args)

    seen_round = object()
    stalled = False
    degraded = False
    failures = 0
    while True:
        try:
            code, health = _http_get_json(base + "/healthz")
        except urllib.error.HTTPError as e:
            code, health = e.code, {"status": f"http {e.code}"}
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError) as e:
            # connection refused/reset — the service is restarting or the
            # monitor is rebinding; back off (capped) and keep polling
            failures += 1
            delay = _watch_backoff(failures, args.interval,
                                   args.max_backoff)
            print(f"[watch] {base} unreachable: {e} "
                  f"(retry {failures} in {delay:.1f}s)", file=sys.stderr)
            if args.once:
                return 2
            time.sleep(delay)
            continue
        failures = 0
        try:
            _, last = _http_get_json(base + "/last-round")
        except Exception:  # noqa: BLE001 — health is the primary signal
            last = {}
        # the cost model's live roofline estimate and the latest mined
        # window, printed on the round line (JAX cli.py:550-566)
        try:
            _, cost = _http_get_json(base + "/programs")
        except Exception:  # noqa: BLE001 — optional endpoint
            cost = {}
        utilization = cost.get("utilization") or {}
        try:
            _, hot = _http_get_json(base + "/hotspots")
        except Exception:  # noqa: BLE001 — optional endpoint
            hot = {}
        hot_windows = hot.get("windows") or {}
        if code == 503:
            if not stalled:
                print_with_color(f"[watch] STALL detected: {health}", "red")
            stalled = True
        else:
            stalled = False
        # degraded ≠ stalled ≠ healthy: the pipelined executor demoted to
        # depth-0 after consecutive rollbacks — progressing, but flagged
        depth = last.get("pipeline_depth")
        depth_text = (f" (depth {depth}"
                      + (f", configured {health['configured_depth']}"
                         if isinstance(health.get("configured_depth"), int)
                         else "") + ")") \
            if isinstance(depth, int) else ""
        if health.get("status") == "degraded":
            if not degraded:
                print_with_color(
                    f"[watch] executor DEGRADED{depth_text}: {health}",
                    "yellow")
            degraded = True
        elif degraded and code != 503:
            print_with_color(
                f"[watch] executor re-promoted (healthy{depth_text})",
                "cyan")
            degraded = False
        rnd = last.get("round")
        if last and rnd != seen_round:
            seen_round = rnd
            keys = [k for k in ("roc_auc", "accuracy", "nll", "train_loss")
                    if isinstance(last.get(k), (int, float))]
            msg = " ".join(f"{k}={last[k]:.4f}" for k in keys)
            # latest drained numerics gauges (--numerics runs): shown next
            # to the round line so a drifting p95 / a non-finite count / a
            # collapsing attack margin is visible live
            numerics = last.get("numerics") or {}
            gauges = [(short, numerics[key]) for short, key in
                      (("unorm_p95", "update_norm_all_p95"),
                       ("nonfinite", "nonfinite_count"),
                       ("sep", "sep_margin"))
                      if isinstance(numerics.get(key), (int, float))]
            if gauges:
                msg += ("  [" + " ".join(f"{k}={v:.4g}" for k, v in gauges)
                        + "]")
            if isinstance(depth, int):
                msg += f" depth={depth}"
            mesh = last.get("mesh_devices")
            if isinstance(mesh, int):
                # the mesh's shape, its strategy suffixed when the monitor
                # knows it (sm = shard_map collectives, g = gspmd)
                strategy = last.get("mesh_strategy")
                msg += f" mesh={mesh}" + (
                    "sm" if strategy == "shard_map"
                    else ("g" if strategy == "gspmd" else ""))
            fraction = utilization.get("utilization_flops")
            achieved = utilization.get("achieved_flops_per_sec")
            if isinstance(fraction, (int, float)):
                msg += f" util={100 * fraction:.1f}%"
            elif isinstance(achieved, (int, float)):
                # no peak spec for this device kind (CPU): achieved-only
                msg += f" flops/s={achieved:.3g}"
            hostbound = [w.get("host_bound_fraction") for w in hot_windows.values()
                         if isinstance(w.get("host_bound_fraction"), (int, float))]
            if hostbound:
                msg += f" hostbound={max(hostbound):.3f}"
            print(f"[watch] round {rnd} ok={last.get('ok')} "
                  f"{msg}".rstrip(), flush=True)
        if args.once:
            return 1 if stalled else 0
        time.sleep(args.interval)


def hotspots_main(argv=None) -> int:
    """``hotspots``: mine profiling windows into op-level device-time
    attribution (show) or gate drift between two profile dirs (diff)
    (JAX cli.py:741-748)."""
    from attackfl_tpu_torch.profiler.cli import main as _hotspots_main

    return _hotspots_main(list(sys.argv[1:] if argv is None else argv))


def matrix_main(argv=None) -> int:
    """``matrix``: the scenario matrix (JAX cli.py:676-683): ``run``
    runs a whole (attack × defense × seed) grid on one device, ``status``
    renders the sweep's per-cell ledger records."""
    from attackfl_tpu_torch.matrix.cli import main as _matrix_main

    return _matrix_main(list(sys.argv[1:] if argv is None else argv))


def cost_main(argv=None) -> int:
    """``cost``: price a config without running it (``estimate``) and
    replay the predictor over a ledger corpus (``validate``) (JAX
    cli.py:686-694)."""
    from attackfl_tpu_torch.costmodel.cli import main as _cost_main

    return _cost_main(list(sys.argv[1:] if argv is None else argv))


def audit_main(argv=None) -> int:
    """``audit``: the AST rules, the event-schema artifacts and the round
    programs' invariants (JAX cli.py:741-756, ``analysis/cli.py``)."""
    from attackfl_tpu_torch.analysis.cli import audit_main as _audit_main

    return _audit_main(list(sys.argv[1:] if argv is None else argv))


def ledger_main(argv=None) -> int:
    """``ledger``: list, show, compare and gate the cross-run ledger's
    records, and import bench artifacts (JAX cli.py:741-756,
    ``ledger/cli.py``)."""
    from attackfl_tpu_torch.ledger.cli import main as _ledger_main

    return _ledger_main(list(sys.argv[1:] if argv is None else argv))


def science_main(argv=None) -> int:
    """``science``: a sweep's leaderboard, scoreboard and rank gate (JAX
    cli.py:753, ``science/cli.py``)."""
    from attackfl_tpu_torch.science.cli import main as _science_main

    return _science_main(list(sys.argv[1:] if argv is None else argv))


def serve_main(argv=None) -> int:
    """``serve``: the run service (JAX cli.py:655-664): a daemon with a
    durable job queue, supervised workers on one device (the card unless
    ``--device cpu``), the preemptive scheduler and an HTTP control plane;
    SIGTERM drains."""
    from attackfl_tpu_torch.service.cli import serve_main as _serve_main

    return _serve_main(list(sys.argv[1:] if argv is None else argv))


def job_main(argv=None) -> int:
    """``job``: the run service's client, submit/list/status/cancel/wait
    over HTTP (JAX cli.py:667-672)."""
    from attackfl_tpu_torch.service.cli import job_main as _job_main

    return _job_main(list(sys.argv[1:] if argv is None else argv))


def fleet_main(argv=None) -> int:
    """``fleet``: the fleet observatory over a service spool (JAX
    cli.py:697-705): ``report`` prints the SLO gauges and the per-tenant
    device-time ledger (the books must close: busy + idle = wall x
    slots), ``trace`` writes the Perfetto-loadable cross-job trace."""
    from attackfl_tpu_torch.telemetry.fleet import main as _fleet_main

    return _fleet_main(list(sys.argv[1:] if argv is None else argv))


_SUBCOMMANDS = {"run": run_main, "server": server_main, "client": client_main,
               "metrics": metrics_main, "watch": watch_main, "hotspots": hotspots_main,
               "cost": cost_main, "matrix": matrix_main, "audit": audit_main,
               "ledger": ledger_main, "science": science_main, "serve": serve_main,
               "job": job_main, "fleet": fleet_main}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return 0 if args else 2
    command = _SUBCOMMANDS.get(args[0])
    if command is None:
        print(f"unknown command {args[0]!r}\n{_USAGE}", end="", file=sys.stderr)
        return 2
    return command(args[1:])
