"""Typed configuration for the PyTorch port.

Its own copy of ``attackfl_tpu.config``: the same dataclasses, field
names, defaults and validation, and the same reference-schema YAML reader
(``config_from_dict`` / ``load_config``), so one ``config.yaml`` loads in
both packages.  The port reads ``local_backend: pallas`` as its
hand-written CUDA kernel (``ops/fused_step.py``) and ``xla`` as the
torch-autograd local update (``training/local.py``).

``faults`` takes the JAX package's fault plans (``faults/plan.py``).
What the port does not run yet is refused in
``training/engine.check_slice``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

import yaml

from attackfl_tpu_torch.faults.plan import FaultSpec, faults_from_config

AGGREGATION_MODES = (
    "fedavg", "hyper", "FLTrust", "trimmed_mean", "shieldfl", "gmm", "krum",
    "median", "scionfl", "fltracer", "byzantine",
)
ATTACK_MODES = ("Random", "Min-Max", "Min-Sum", "Opt-Fang", "LIE")
# clean-baseline attacker cohort: keeps its geometry, never fires
NONE_ATTACK = "none"
MAX_PIPELINE_DEPTH = 32
DATA_NAMES = ("ICU", "HAR", "CIFAR10")


@dataclass(frozen=True)
class HyperDetectionConfig:
    """Embedding anomaly defense knobs (reference config.yaml:6-11)."""

    enable: bool = False
    cosine_search: int = 10
    n_components: int = 3
    eps: float = 0.007
    min_samples: int = 3
    start_round: int = 18


def parse_profile_rounds(spec: str) -> tuple[int, int] | None:
    """Parse an ``A:B`` round window ("A" alone means A:A); None if empty."""
    if not spec:
        return None
    start_text, sep, stop_text = spec.partition(":")
    try:
        start = int(start_text)
        stop = int(stop_text) if sep else start
    except ValueError:
        raise ValueError(
            f"profile_rounds must be 'A:B' (integers), got {spec!r}") from None
    if not 1 <= start <= stop:
        raise ValueError(f"profile_rounds needs 1 <= A <= B, got {spec!r}")
    return start, stop


@dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs: the event log (``events.jsonl``), the Chrome
    trace (``trace.json``), the counters and the cross-run ledger, under
    ``log_path`` unless a path is given; the opt-in numerics ring and live
    monitor; ``hotspots`` (or ``profile_rounds``), an ``A:B`` round window
    profiled by ``torch.profiler``; ``costmodel``, each program's counted
    profile as a ``program_profile`` event, on by default as in the JAX
    package (``ATTACKFL_COSTMODEL=0`` switches it off)."""

    enabled: bool = True
    sample_every: int = 1
    events_path: str = ""
    trace_path: str = ""
    monitor: bool = False
    monitor_port: int = 8780
    stall_factor: float = 10.0
    stall_grace_seconds: float = 900.0
    profile_rounds: str = ""
    hotspots: str = ""
    numerics: bool = False
    numerics_window: int = 16
    ledger: bool = True
    ledger_dir: str = ""
    costmodel: bool = True

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError(
                f"telemetry.sample_every must be >= 1, got {self.sample_every}")
        if not 0 <= self.monitor_port <= 65535:
            raise ValueError(
                f"telemetry.monitor_port must be a port, got {self.monitor_port}")
        if self.stall_factor <= 1.0:
            raise ValueError(
                "telemetry.stall_factor must be > 1 (a factor of the median "
                f"round time), got {self.stall_factor}")
        if self.stall_grace_seconds <= 0:
            raise ValueError(
                f"telemetry.stall_grace_seconds must be > 0, got "
                f"{self.stall_grace_seconds}")
        parse_profile_rounds(self.profile_rounds)
        parse_profile_rounds(self.hotspots)
        if not 2 <= self.numerics_window <= 65536:
            raise ValueError(
                "telemetry.numerics_window must be in [2, 65536], got "
                f"{self.numerics_window}")


@dataclass(frozen=True)
class ServiceConfig:
    """Run-service daemon knobs (read by no port code yet)."""

    spool_dir: str = ""
    port: int = 8781
    host: str = "0.0.0.0"
    max_workers: int = 1
    queue_depth: int = 16
    worker_retries: int = 2
    worker_backoff: float = 0.5
    worker_backoff_cap: float = 30.0
    run_monitors: bool = True
    drain_grace_seconds: float = 120.0
    scheduler: bool = True
    sched_aging_rate: float = 1.0
    sched_min_runtime: float = 2.0
    sched_shed_horizon: float = 0.0
    sched_breaker_attempts: int = 5
    sched_default_cost: float = 30.0

    def __post_init__(self):
        if not 0 <= self.port <= 65535:
            raise ValueError(f"service.port must be a port, got {self.port}")
        if self.max_workers < 1:
            raise ValueError(
                f"service.max_workers must be >= 1, got {self.max_workers}")
        if self.queue_depth < 1:
            raise ValueError(
                f"service.queue_depth must be >= 1, got {self.queue_depth}")
        if self.worker_retries < 0:
            raise ValueError(
                f"service.worker_retries must be >= 0, got {self.worker_retries}")
        if self.worker_backoff <= 0 or self.worker_backoff_cap <= 0:
            raise ValueError(
                "service.worker_backoff and worker_backoff_cap must be > 0, "
                f"got {self.worker_backoff} / {self.worker_backoff_cap}")
        if self.drain_grace_seconds <= 0:
            raise ValueError(
                f"service.drain_grace_seconds must be > 0, got "
                f"{self.drain_grace_seconds}")
        if self.sched_aging_rate <= 0:
            raise ValueError(
                f"service.sched_aging_rate must be > 0, got {self.sched_aging_rate}")
        if self.sched_min_runtime < 0:
            raise ValueError(
                f"service.sched_min_runtime must be >= 0, got "
                f"{self.sched_min_runtime}")
        if self.sched_shed_horizon < 0:
            raise ValueError(
                f"service.sched_shed_horizon must be >= 0, got "
                f"{self.sched_shed_horizon}")
        if self.sched_breaker_attempts < 1:
            raise ValueError(
                f"service.sched_breaker_attempts must be >= 1, got "
                f"{self.sched_breaker_attempts}")
        if self.sched_default_cost <= 0:
            raise ValueError(
                f"service.sched_default_cost must be > 0, got "
                f"{self.sched_default_cost}")


@dataclass(frozen=True)
class AttackSpec:
    """One group of attacker clients (reference client.py:19-38).

    ``client_ids`` empty means the *last* ``num_clients`` indices;
    ``attack_round`` is the first broadcast (1-based) at which it fires;
    ``args`` are the positional attack arguments (LIE: the z factor)."""

    mode: str = "LIE"
    num_clients: int = 0
    client_ids: tuple[int, ...] = ()
    attack_round: int = 1
    args: tuple[float, ...] = ()

    def __post_init__(self):
        if self.mode not in ATTACK_MODES and self.mode != NONE_ATTACK:
            raise ValueError(
                f"Unknown attack mode {self.mode!r}; choose from "
                f"{ATTACK_MODES} (or {NONE_ATTACK!r} for a clean-baseline "
                "cohort that never fires)")
        object.__setattr__(self, "args", tuple(float(x) for x in self.args))
        object.__setattr__(self, "client_ids", tuple(self.client_ids))


@dataclass(frozen=True)
class MeshConfig:
    """Device layout of the client axis (the port runs on one device)."""

    num_devices: int = 0
    axis_name: str = "clients"
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    # --- server section (reference config.yaml:2-22) ---
    num_round: int = 30
    total_clients: int = 3
    mode: str = "fedavg"
    model: str = "TransformerModel"
    data_name: str = "ICU"
    load_parameters: bool = False
    reload_parameters_per_round: bool = False
    validation: bool = True
    validation_every: int = 1
    validation_async: bool = False
    pipeline: bool = False
    pipeline_depth: int | str = 1
    checkpoint_async: bool = False
    resume: bool = False
    checkpoint_keep: int = 3
    pipeline_demote_after: int = 3
    pipeline_repromote_after: int = 5
    num_data_range: tuple[int, int] = (12000, 15000)
    genuine_rate: float = 0.5
    random_seed: int = 1
    data_seed: int | None = None
    hyper_detection: HyperDetectionConfig = field(default_factory=HyperDetectionConfig)
    hyper_class: str = "HyperNetwork"
    hyper_spec_norm: bool = False
    hyper_update_mode: str = "sequential"
    client_dropout_rate: float = 0.0
    partition: str = "iid"
    dirichlet_alpha: float = 0.5

    # --- learning section (reference config.yaml:31-37) ---
    epochs: int = 5
    lr: float = 0.004
    hyper_lr: float = 0.001
    momentum: float = 0.5  # accepted for schema parity; Adam ignores it
    batch_size: int = 128
    clip_grad_norm: float = 1.0

    # --- attackers ---
    attacks: tuple[AttackSpec, ...] = ()

    # --- deterministic scheduled failures (YAML `faults:` section / CLI
    # `--inject-faults`): device-side kinds in the round step, host-side
    # ones at the checkpoint seams (faults/) ---
    faults: tuple[FaultSpec, ...] = ()

    # --- infra ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    log_path: str = "."
    checkpoint_dir: str = "."
    compile_cache_dir: str = ""
    krum_f: int = 0
    trim_ratio: float = 0.1
    byzantine_threshold: float = 0.9
    # JAX key implementation; the port draws from torch.Generators and
    # keeps the field only so the same YAML validates in both packages
    prng_impl: str = "rbg"
    scan_unroll: int = 1
    # "pallas": the hand-written CUDA kernel (ops/fused_step.py);
    # "xla": the torch-autograd local update (training/local.py)
    local_backend: str = "xla"
    train_size: int = 20000
    test_size: int = 4000

    def __post_init__(self):
        if self.prng_impl == "threefry":
            object.__setattr__(self, "prng_impl", "threefry2x32")
        if self.prng_impl not in ("rbg", "unsafe_rbg", "threefry2x32"):
            raise ValueError(
                f"Unknown prng_impl {self.prng_impl!r}; choose rbg, "
                "unsafe_rbg or threefry2x32")
        if self.scan_unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {self.scan_unroll}")
        if self.validation_every < 1:
            raise ValueError(
                f"validation_every must be >= 1 (1 = every round; disable "
                f"validation with validation: false), got {self.validation_every}")
        if self.checkpoint_keep < 1:
            raise ValueError(
                f"checkpoint_keep must be >= 1, got {self.checkpoint_keep}")
        if isinstance(self.pipeline_depth, str):
            depth_text = self.pipeline_depth.strip().lower()
            if depth_text != "auto":
                try:
                    object.__setattr__(self, "pipeline_depth", int(depth_text))
                except ValueError:
                    raise ValueError(
                        f"pipeline_depth must be an integer or 'auto', got "
                        f"{self.pipeline_depth!r}") from None
            else:
                object.__setattr__(self, "pipeline_depth", "auto")
        if isinstance(self.pipeline_depth, int) and not (
                0 <= self.pipeline_depth <= MAX_PIPELINE_DEPTH):
            raise ValueError(
                f"pipeline_depth must be in [0, {MAX_PIPELINE_DEPTH}] or "
                f"'auto', got {self.pipeline_depth}")
        if self.pipeline_demote_after < 1 or self.pipeline_repromote_after < 1:
            raise ValueError(
                "pipeline_demote_after and pipeline_repromote_after must be "
                f">= 1, got {self.pipeline_demote_after} / "
                f"{self.pipeline_repromote_after}")
        for spec in self.faults:
            for cid in spec.clients:
                if not 0 <= cid < self.total_clients:
                    raise ValueError(
                        f"fault {spec.kind}@{spec.round}: client {cid} out "
                        f"of range [0, {self.total_clients})")
        if self.reload_parameters_per_round and not self.load_parameters:
            raise ValueError(
                "reload_parameters_per_round is gated on parameters.load "
                "(reference server.py:580) — set load_parameters=True as well")
        if self.mesh.compute_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(
                f"Unknown compute-dtype {self.mesh.compute_dtype!r}; choose "
                "float32, bfloat16 or float16")
        if self.local_backend not in ("xla", "pallas"):
            raise ValueError(
                f"Unknown local_backend {self.local_backend!r}; choose xla or pallas")
        if self.local_backend == "pallas" and (
                self.model != "TransformerModel" or self.data_name != "ICU"):
            raise ValueError(
                "local_backend 'pallas' implements the flagship "
                "TransformerModel-on-ICU step only; use local_backend 'xla'")
        if self.local_backend == "pallas" and self.mesh.compute_dtype != "float32":
            raise ValueError(
                "local_backend 'pallas' computes in float32 (the fused "
                "kernel is hardwired f32); compute-dtype applies to the "
                "xla backend only")
        if self.local_backend == "pallas" and self.mode == "hyper":
            raise ValueError(
                "local_backend 'pallas' fuses the plain local-training step; "
                "hyper mode runs on the xla backend only")
        if self.mode not in AGGREGATION_MODES:
            raise ValueError(
                f"Unknown server mode {self.mode!r}; choose from {AGGREGATION_MODES}")
        if self.data_name not in DATA_NAMES:
            raise ValueError(
                f"Unknown data name {self.data_name!r}; choose from {DATA_NAMES}")
        lo, hi = self.num_data_range
        if not (0 < lo <= hi):
            raise ValueError(f"Bad num-data-range {self.num_data_range}")
        if not (0.0 <= self.client_dropout_rate < 1.0):
            raise ValueError(
                f"client_dropout_rate must be in [0, 1), got "
                f"{self.client_dropout_rate}")
        if self.hyper_update_mode not in ("sequential", "batched"):
            raise ValueError(
                f"Unknown hyper_update_mode {self.hyper_update_mode!r}; "
                "choose 'sequential' or 'batched'")
        if self.hyper_class not in ("HyperNetwork", "CNNHyper"):
            raise ValueError(
                f"Unknown hyper_class {self.hyper_class!r}; choose "
                "HyperNetwork or CNNHyper")
        if (self.hyper_class == "CNNHyper" and self.mode == "hyper"
                and self.model != "CNNModel"):
            raise ValueError(
                "hyper_class 'CNNHyper' is hand-specialized to CNNModel; "
                f"got model {self.model!r}")
        if self.mode == "hyper" and self.validation and self.data_name == "HAR":
            raise ValueError(
                "mode 'hyper' with validation has no HAR evaluator; use "
                "data-name ICU/CIFAR10 or disable validation")

    def attacker_assignment(self) -> dict[int, AttackSpec]:
        """Map client index -> attack spec.  Non-attackers are absent."""
        assignment: dict[int, AttackSpec] = {}
        next_free = self.total_clients
        for spec in self.attacks:
            ids: Sequence[int]
            if spec.client_ids:
                ids = spec.client_ids
            else:
                next_free -= spec.num_clients
                ids = range(next_free, next_free + spec.num_clients)
            for cid in ids:
                if not 0 <= cid < self.total_clients:
                    raise ValueError(
                        f"Attacker id {cid} out of range [0, {self.total_clients})")
                if cid in assignment:
                    raise ValueError(f"Client {cid} claimed by two attack specs")
                assignment[cid] = spec
        return assignment

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def audit_config(scratch: str, **overrides: Any) -> Config:
    """Representative CPU-sized config for the program audit
    (``analysis/program_audit``) and the recompile guard (JAX
    ``attackfl_tpu/config.py`` ``audit_config``).

    Small enough to run each program in seconds on the CPU, yet it
    exercises the full round: an active LIE attacker group, validation
    (folded into the fused and pipelined bodies) and the default fedavg
    aggregation.  Telemetry is off (an audit writes no event files and
    starts no monitor) and logs and checkpoints go to ``scratch``, a
    throwaway directory that the caller owns and removes.  Keyword
    overrides replace any field (``mode="hyper"`` audits the
    hypernetwork's programs)."""
    base: dict[str, Any] = dict(
        num_round=3, total_clients=4, mode="fedavg", model="CNNModel",
        data_name="ICU", num_data_range=(48, 64), epochs=1, batch_size=32,
        train_size=256, test_size=128,
        attacks=(AttackSpec(mode="LIE", num_clients=1, attack_round=2),),
        telemetry=TelemetryConfig(enabled=False),
        log_path=scratch, checkpoint_dir=scratch,
    )
    base.update(overrides)
    return Config(**base)


def _get(d: dict, key: str, default: Any) -> Any:
    return d.get(key, default) if isinstance(d, dict) else default


def config_from_dict(raw: dict) -> Config:
    """Build a Config from a dict using the reference YAML key names."""
    server = _get(raw, "server", {})
    learning = _get(raw, "learning", {})
    hd = _get(server, "hyper-detection", {})
    dist = _get(server, "data-distribution", {})
    ndr = _get(dist, "num-data-range", [12000, 15000])
    mesh = _get(raw, "tpu", {})
    tele = _get(raw, "telemetry", {})
    svc = _get(raw, "service", {})

    attacks = []
    for a in _get(raw, "attack-clients", []) or []:
        attacks.append(AttackSpec(
            mode=_get(a, "mode", "LIE"),
            num_clients=int(_get(a, "num-clients", 0)),
            client_ids=tuple(_get(a, "client-ids", []) or []),
            attack_round=int(_get(a, "attack-round", 1)),
            args=tuple(float(x) for x in (_get(a, "args", []) or [])),
        ))

    defaults = Config()
    return Config(
        num_round=int(_get(server, "num-round", defaults.num_round)),
        total_clients=int(_get(server, "clients", defaults.total_clients)),
        mode=str(_get(server, "mode", defaults.mode)),
        model=str(_get(server, "model", defaults.model)),
        data_name=str(_get(server, "data-name", defaults.data_name)),
        load_parameters=bool(_get(_get(server, "parameters", {}), "load", False)),
        reload_parameters_per_round=bool(_get(
            _get(server, "parameters", {}), "reload-per-round",
            defaults.reload_parameters_per_round)),
        validation=bool(_get(server, "validation", True)),
        validation_every=int(_get(server, "validation-every",
                                  defaults.validation_every)),
        validation_async=bool(_get(server, "validation-async",
                                   defaults.validation_async)),
        pipeline=bool(_get(server, "pipeline", defaults.pipeline)),
        pipeline_depth=_get(server, "pipeline-depth", defaults.pipeline_depth),
        checkpoint_async=bool(_get(server, "checkpoint-async",
                                   defaults.checkpoint_async)),
        resume=bool(_get(server, "resume", defaults.resume)),
        checkpoint_keep=int(_get(server, "checkpoint-keep",
                                 defaults.checkpoint_keep)),
        pipeline_demote_after=int(_get(server, "pipeline-demote-after",
                                       defaults.pipeline_demote_after)),
        pipeline_repromote_after=int(_get(
            server, "pipeline-repromote-after",
            defaults.pipeline_repromote_after)),
        num_data_range=(int(ndr[0]), int(ndr[1])),
        genuine_rate=float(_get(server, "genuine-rate", defaults.genuine_rate)),
        random_seed=int(_get(server, "random-seed", defaults.random_seed) or 0),
        data_seed=(int(_get(server, "data-seed", 0))
                   if _get(server, "data-seed", None) is not None else None),
        hyper_detection=HyperDetectionConfig(
            enable=bool(_get(hd, "enable", False)),
            cosine_search=int(_get(hd, "cosine-search", 10)),
            n_components=int(_get(hd, "n_components", 3)),
            eps=float(_get(hd, "eps", 0.007)),
            min_samples=int(_get(hd, "min_samples", 3)),
            start_round=int(_get(hd, "start-round", 18)),
        ),
        client_dropout_rate=float(_get(server, "client-dropout-rate",
                                       defaults.client_dropout_rate)),
        hyper_class=str(_get(server, "hyper-class", defaults.hyper_class)),
        hyper_spec_norm=bool(_get(server, "hyper-spec-norm",
                                  defaults.hyper_spec_norm)),
        hyper_update_mode=str(_get(server, "hyper-update-mode",
                                   defaults.hyper_update_mode)),
        partition=str(_get(server, "partition", defaults.partition)),
        dirichlet_alpha=float(_get(server, "dirichlet-alpha",
                                   defaults.dirichlet_alpha)),
        epochs=int(_get(learning, "epoch", defaults.epochs)),
        lr=float(_get(learning, "learning-rate", defaults.lr)),
        hyper_lr=float(_get(learning, "hyper-lr", defaults.hyper_lr)),
        momentum=float(_get(learning, "momentum", defaults.momentum)),
        batch_size=int(_get(learning, "batch-size", defaults.batch_size)),
        clip_grad_norm=float(_get(learning, "clip-grad-norm",
                                  defaults.clip_grad_norm)),
        attacks=tuple(attacks),
        faults=faults_from_config(_get(raw, "faults", []) or []),
        mesh=MeshConfig(
            num_devices=int(_get(mesh, "num-devices", 0)),
            axis_name=str(_get(mesh, "axis-name", "clients")),
            compute_dtype=str(_get(mesh, "compute-dtype", "float32")),
        ),
        telemetry=TelemetryConfig(
            enabled=bool(_get(tele, "enabled", True)),
            sample_every=int(_get(tele, "sample-every", 1)),
            events_path=str(_get(tele, "events-path", "")),
            trace_path=str(_get(tele, "trace-path", "")),
            monitor=bool(_get(tele, "monitor", False)),
            monitor_port=int(_get(tele, "monitor-port", 8780)),
            stall_factor=float(_get(tele, "stall-factor", 10.0)),
            stall_grace_seconds=float(_get(tele, "stall-grace-seconds", 900.0)),
            profile_rounds=str(_get(tele, "profile-rounds", "")),
            hotspots=str(_get(tele, "hotspots", "")),
            numerics=bool(_get(tele, "numerics", False)),
            numerics_window=int(_get(tele, "numerics-window", 16)),
            ledger=bool(_get(tele, "ledger", True)),
            ledger_dir=str(_get(tele, "ledger-dir", "")),
            costmodel=bool(_get(tele, "costmodel", True)),
        ),
        service=ServiceConfig(
            spool_dir=str(_get(svc, "spool-dir", "")),
            port=int(_get(svc, "port", 8781)),
            host=str(_get(svc, "host", "0.0.0.0")),
            max_workers=int(_get(svc, "max-workers", 1)),
            queue_depth=int(_get(svc, "queue-depth", 16)),
            worker_retries=int(_get(svc, "worker-retries", 2)),
            worker_backoff=float(_get(svc, "worker-backoff", 0.5)),
            worker_backoff_cap=float(_get(svc, "worker-backoff-cap", 30.0)),
            run_monitors=bool(_get(svc, "run-monitors", True)),
            drain_grace_seconds=float(_get(svc, "drain-grace-seconds", 120.0)),
        ),
        log_path=str(_get(raw, "log_path", ".")),
        checkpoint_dir=str(_get(raw, "checkpoint-dir", _get(raw, "log_path", "."))),
        compile_cache_dir=str(_get(raw, "compile-cache-dir",
                                   defaults.compile_cache_dir)),
        local_backend=str(_get(mesh, "local-backend", defaults.local_backend)),
        krum_f=int(_get(server, "krum-f", defaults.krum_f)),
        trim_ratio=float(_get(server, "trim-ratio", defaults.trim_ratio)),
        byzantine_threshold=float(_get(server, "byzantine-threshold",
                                       defaults.byzantine_threshold)),
        train_size=int(_get(server, "train-size", defaults.train_size)),
        test_size=int(_get(server, "test-size", defaults.test_size)),
    )


def load_config(path: str) -> Config:
    with open(path, "r") as fh:
        raw = yaml.safe_load(fh) or {}
    return config_from_dict(raw)
