"""The port's attribution (``training/round.build_attribution_fn`` and the
engine's ``attribution`` event) against the JAX package's, on the CPU, on
the rounds of ``test_torch_port_defense_round.py`` (8 clients, 2 LIE
attackers, the JAX round step's rows with dropout off, one plain round
and one with stragglers at rate 0.4).

1. Each mode's attribution function on the same stacked rows, sizes,
   mask and draws (ScionFL's uniforms and FLTrust's root shuffles from
   the same threefry key): JAX's ``keep`` exactly and its ``scores``
   within 1e-5, with two exceptions.  FLTrust's within 2e-4, the defended
   round's parameter tolerance: its trust scores are cosines against a
   root update trained in float32.  ShieldFL's within 5e-4 of
   themselves: its weights are 1 / (1 - cos + 1e-6), and on trained rows
   1 - cos is ~3e-3, so a float32 cosine's ~1e-6 is ~3e-4 of a weight
   (``test_torch_port_defenses.py`` holds them to 2e-5 of a float64
   evaluation on rows where 1 - cos is larger).  With stragglers under
   the masked forms.
2. The engine's ``attribution`` event of a ``run_round`` on those draws:
   its attackers are the round's active attackers, its kept and removed
   clients JAX's verdict (the host filter's mask for gmm and fltracer),
   and the round's params with telemetry on equal those with telemetry
   off bit for bit: the attribution draws nothing.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax
from tests.test_torch_port_defense_round import (  # noqa: F401  (fixtures)
    ATTACK, C, DEFENSES, RATE, SHARED, _agg_draws, _jax_aggregate, _jcfg, _port_round,
    plain_round, straggler_round,
)
from tests.test_torch_port_local import JaxDropoutOff, PortDropoutOff

DEVICE_MODES = ("median", "trimmed_mean", "krum", "shieldfl", "byzantine", "scionfl",
                "FLTrust")
# (rtol, atol) of the scores against JAX's, by mode (see the docstring)
SCORE_TOL = {"FLTrust": (0, 2e-4), "shieldfl": (5e-4, 0)}


def _both(rnd: dict, mode: str, rate: float):
    """(JAX keep, JAX scores, port keep, port scores) on the round."""
    sizes = rnd["sizes"]
    weights_mask = jnp.ones(C) * (sizes > 0)
    jattr = jround.build_attribution_fn(JaxDropoutOff(), _jcfg(mode=mode,
                                                               client_dropout_rate=rate),
                                        rnd["test"])
    jkeep, jscores = jattr(rnd["params"], rnd["stacked"], sizes, weights_mask, rnd["k_agg"])
    cfg = Config(**SHARED, mode=mode, client_dropout_rate=rate, attacks=(AttackSpec(**ATTACK),))
    test = {k: torch.from_numpy(v) for k, v in rnd["test"].items()}
    tattr = tround.build_attribution_fn(PortDropoutOff(), cfg, test)
    stacked = params_from_jax(jax.tree.map(np.asarray, rnd["stacked"]))
    tsizes = torch.from_numpy(np.asarray(sizes, dtype=np.int64))
    draws = _agg_draws(rnd["draws"], mode, rnd["k_agg"],
                       sum(x[0].numel() for x in pt.tree_leaves(stacked)))
    tkeep, tscores = tattr(params_from_jax(jax.tree.map(np.asarray, rnd["params"])), stacked,
                           tsizes, torch.ones(C) * (tsizes > 0), draws)
    return (np.asarray(jkeep), np.asarray(jscores, dtype=np.float64), tkeep.numpy(),
            tscores.to(torch.float64).numpy())


@pytest.mark.parametrize("mode", DEVICE_MODES)
def test_attribution_fn_matches_jax(mode, plain_round):
    jkeep, jscores, tkeep, tscores = _both(plain_round, mode, 0.0)
    assert tkeep.dtype == np.bool_ and tkeep.tolist() == jkeep.tolist()
    rtol, atol = SCORE_TOL.get(mode, (0, 1e-5))
    np.testing.assert_allclose(tscores, jscores, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["median", "trimmed_mean", "krum", "shieldfl", "byzantine"])
def test_attribution_fn_with_stragglers_matches_jax(mode, straggler_round):
    """The masked forms: a dropped client is never kept."""
    jkeep, jscores, tkeep, tscores = _both(straggler_round, mode, RATE)
    assert tkeep.tolist() == jkeep.tolist()
    rtol, atol = SCORE_TOL.get(mode, (0, 1e-5))
    np.testing.assert_allclose(tscores, jscores, rtol=rtol, atol=atol)
    dropped = ~straggler_round["draws"].kept.numpy()
    assert not tkeep[dropped].any()


def test_modes_without_a_verdict_build_none():
    for mode in ("fedavg", "gmm", "fltracer"):
        cfg = Config(**SHARED, mode=mode, attacks=(AttackSpec(**ATTACK),))
        assert tround.build_attribution_fn(PortDropoutOff(), cfg) is None
        assert jround.build_attribution_fn(JaxDropoutOff(), _jcfg(mode=mode), None) is None


def _sim(monkeypatch, mode: str, enabled: bool) -> Simulator:
    monkeypatch.setattr(engine, "get_model", lambda name: PortDropoutOff())
    return Simulator(Config(**SHARED, mode=mode, attacks=(AttackSpec(**ATTACK),),
                            telemetry=TelemetryConfig(enabled=enabled)), device="cpu")


@pytest.mark.parametrize("mode", DEFENSES)
def test_attribution_event_names_the_attackers(mode, plain_round, tmp_path, monkeypatch):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    sim = _sim(monkeypatch, mode, True)
    _, new, metrics = _port_round(sim, plain_round, mode)
    sim.close()
    with open(tmp_path / "events.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    events = [e for e in records if e["kind"] == "attribution"]
    assert [e["kind"] for e in records] == ["run_header", "attribution", "round"]
    event = events[0]
    if mode in ("gmm", "fltracer"):
        _, keep, _ = _jax_aggregate(plain_round, mode)
    else:
        keep, _, _, _ = _both(plain_round, mode, 0.0)
    assert event["attackers"] == sorted(plain_round["attackers"])
    assert event["kept"] == np.flatnonzero(keep).tolist()
    assert event["removed"] == np.flatnonzero(~keep).tolist()
    assert event["non_reporting"] == [] and len(event["scores"]) == C
    assert metrics["defense_removed"] == len(event["removed"])
    assert set(metrics["phases"]) >= {"train", "attribution", "aggregate", "validate"}

    off = _sim(monkeypatch, mode, False)
    _, new_off, metrics_off = _port_round(off, plain_round, mode)
    assert metrics_off["ok"] == metrics["ok"] and metrics_off["roc_auc"] == metrics["roc_auc"]
    for (key, a), (_, b) in zip(pt.tree_items(new["global_params"]),
                                pt.tree_items(new_off["global_params"])):
        assert torch.equal(a, b), key
