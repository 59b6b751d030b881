"""Final-metric parity of CNNModel, RNNModel, the HAR classifier and
ResNet18 in float32: each package's own Simulator, its own draws, at
CPU-cheap sizes over several seeds (outside tier-1; ROADMAP §3's seed
table).

    python tests/torch_port_final_parity.py [--models CNNModel,...] [--seeds 1,2,3] [--no-dropout]
        [--rounds N]

Each run is ``local_backend: xla`` with dropout on (``--no-dropout``:
off in both packages), the JAX package on its threefry keys and the port
on its own generator, so the two runs of a seed share the config and the
data and differ in their draws: the comparison is between seeds, not
between bits.  Prints one line a run (rounds ok, the metric by round,
seconds) and one JSON line a model with both packages' final metrics by
seed and the mean port - JAX gap.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from attackfl_tpu.config import AttackSpec as JaxAttackSpec  # noqa: E402
from attackfl_tpu.config import Config as JaxConfig  # noqa: E402
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig  # noqa: E402
from attackfl_tpu.training.engine import Simulator as JaxSimulator  # noqa: E402
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig  # noqa: E402
from attackfl_tpu_torch.training.engine import Simulator  # noqa: E402

# each model's run: BASELINE's shape (bench.py:82-110) cut to CPU-cheap
# sizes; the metric its validation gates on
ICU = dict(total_clients=3, data_name="ICU", num_data_range=(256, 384), epochs=1,
           batch_size=64, train_size=4096, test_size=1024, num_round=10)
RUNS = {
    "CNNModel": (dict(ICU, model="CNNModel"), "roc_auc"),
    "RNNModel": (dict(ICU, model="RNNModel"), "roc_auc"),
    "TransformerClassifier": (dict(ICU, model="TransformerClassifier", data_name="HAR",
                                   num_data_range=(128, 192), batch_size=32, train_size=2048,
                                   test_size=512, num_round=5), "accuracy"),
    "ResNet18": (dict(total_clients=4, model="ResNet18", data_name="CIFAR10",
                      num_data_range=(64, 96), epochs=1, batch_size=32, train_size=1024,
                      test_size=256, num_round=3,
                      attacks=(dict(mode="Opt-Fang", num_clients=1, attack_round=2,
                                    args=(50.0, 1.0)),)), "accuracy"),
}


class _JaxEval:
    """A JAX model whose training forward is its evaluation forward (no
    dropout), every other attribute the model's."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def apply(self, variables, *inputs, train=False, rngs=None, **kw):
        return self._inner.apply(variables, *inputs, train=False, **kw)


def no_dropout() -> None:
    """Both packages' Simulators build their models without dropout."""
    from attackfl_tpu import registry as jax_registry
    from attackfl_tpu.training import engine as jax_engine
    from attackfl_tpu_torch import registry
    from attackfl_tpu_torch.training import engine

    jax_engine.get_model = lambda name, **kw: _JaxEval(jax_registry.get_model(name, **kw))
    engine.get_model = lambda name, **kw: _dropout_off(registry.get_model(name, **kw))


def _dropout_off(model):
    model.dropout_rates = (0.0,) * len(model.dropout_rates)
    return model


def run_one(package: str, shape: dict, seed: int, workdir: str) -> tuple[list, float]:
    """One run of ``package`` (jax or port): its history and seconds."""
    shared = {k: v for k, v in shape.items() if k != "attacks"}
    shared.update(mode="fedavg", lr=0.004, clip_grad_norm=1.0, genuine_rate=0.5,
                  local_backend="xla", random_seed=seed, log_path=workdir,
                  checkpoint_dir=workdir)
    attacks = shape.get("attacks", ())
    t0 = time.perf_counter()
    if package == "jax":
        cfg = JaxConfig(**shared, attacks=tuple(JaxAttackSpec(**a) for a in attacks),
                        telemetry=JaxTelemetryConfig(enabled=False))
        _, history = JaxSimulator(cfg).run(save_checkpoints=False, verbose=False)
    else:
        cfg = Config(**shared, attacks=tuple(AttackSpec(**a) for a in attacks),
                     telemetry=TelemetryConfig(enabled=False))
        _, history = Simulator(cfg, device="cpu").run(save_checkpoints=False, verbose=False)
    return history, time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default=",".join(RUNS))
    parser.add_argument("--seeds", default="1,2,3")
    parser.add_argument("--no-dropout", action="store_true")
    parser.add_argument("--rounds", type=int, default=None, help="in place of each model's rounds")
    args = parser.parse_args(argv)
    if args.no_dropout:
        no_dropout()
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    for model in args.models.split(","):
        shape, metric = RUNS[model]
        if args.rounds:
            shape = dict(shape, num_round=args.rounds)
        finals = {"jax": [], "port": []}
        for seed in seeds:
            for package in ("jax", "port"):
                with tempfile.TemporaryDirectory() as workdir:
                    history, seconds = run_one(package, shape, seed, workdir)
                ok = sum(bool(h["ok"]) for h in history)
                by_round = [round(float(h[metric]), 4) for h in history]
                finals[package].append(by_round[-1])
                print(f"{model} seed {seed} {package}: {ok} of {len(history)} rounds ok, "
                      f"{metric} by round {by_round}, {seconds:.1f} s", flush=True)
        gap = float(np.mean(np.array(finals["port"]) - np.array(finals["jax"])))
        print(json.dumps({"model": model, "metric": metric, "seeds": seeds, **finals,
                          "mean_port_minus_jax": round(gap, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
