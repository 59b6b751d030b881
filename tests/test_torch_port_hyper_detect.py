"""Hyper mode's embedding detector at config 4's shape: the port's hyper
rounds against the JAX package's on the CPU, with the detector's removals
per round.

Each package runs its own hyper rounds as its engine does (JAX
``engine.py:1673-1800``, the port's ``Simulator._run_hyper_round``): the
round step from the hypernetwork, the hypernetwork update over the
reporting active clients, ``generate_all``'s embeddings, the detector's
``observe`` on the active clients' rows and, on a removal, the rollback
of the round's update with the removed clients left inactive.  Both sides
start from the same seeded hypernetwork (TransformerModel's
``HyperNetwork``) and take the same draws (JAX's key schedule, fed to the
port through ``RoundDraws``), with dropout off and in float64 (JAX under
``enable_x64``): in float32 Adam's cold start turns noise-level
gradients into steps of up to ``hyper_lr``.  The detector is the
reference's (``eps`` 0.007, 3 components, ``min_samples`` 3), from round
2 with a 5-round history.  The test holds the removals and ``ok`` of
every round equal and the embeddings within ``EMB_TOL``.

``python tests/test_torch_port_hyper_detect.py --clients 100`` runs
config 4 (cut) in hyper mode (100 clients, 25 LIE attackers, 1,200-1,500
samples a client, 2 epochs, 3 rounds: ``profile_round.DEPTH["cut"]``) the
same way, outside tier-1, and prints both packages' removals per round.
"""

import argparse
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

# run as a script: the tests' helpers and the two packages
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from _torch_port_models import JaxDropoutOff, as_dtype, as_t, dropout_off, jax_perms  # noqa: E402
from _torch_port_threads import one_torch_thread  # noqa: E402,F401
from attackfl_tpu.config import AttackSpec as JaxAttackSpec  # noqa: E402
from attackfl_tpu.config import Config as JaxConfig  # noqa: E402
from attackfl_tpu.config import HyperDetectionConfig as JaxHyperDetectionConfig  # noqa: E402
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig  # noqa: E402
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices  # noqa: E402
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset  # noqa: E402
from attackfl_tpu.models import icu as jicu  # noqa: E402
from attackfl_tpu.models.hyper import make_hypernetwork as jax_make_hypernetwork  # noqa: E402
from attackfl_tpu.ops import defenses as jdefenses  # noqa: E402
from attackfl_tpu.training import round as jround  # noqa: E402
from attackfl_tpu.training.hyper import build_hyper_round as jax_build_hyper_round  # noqa: E402
from attackfl_tpu.training.hyper import build_hyper_update as jax_build_hyper_update  # noqa: E402
from attackfl_tpu_torch.config import AttackSpec, Config, HyperDetectionConfig  # noqa: E402
from attackfl_tpu_torch.data.partition import RoundDraws  # noqa: E402
from attackfl_tpu_torch.models.hyper import make_hypernetwork  # noqa: E402
from attackfl_tpu_torch.ops import defenses  # noqa: E402
from attackfl_tpu_torch.ops import pytree as pt  # noqa: E402
from attackfl_tpu_torch.registry import get_model  # noqa: E402
from attackfl_tpu_torch.training import round as tround  # noqa: E402
from attackfl_tpu_torch.training.hyper import build_hyper_round  # noqa: E402
from attackfl_tpu_torch.training.hyper import build_hyper_update  # noqa: E402
from attackfl_tpu_torch.weights import hnet_params_from_jax  # noqa: E402

EMB_TOL = 1e-6
# the tier-1 cut of config 4's shape: a fifth of its clients and attackers
SMALL = dict(clients=20, attackers=5, rounds=3, num_data_range=(24, 32), epochs=1,
             batch_size=16, train_size=512)
# config 4 (cut) in hyper mode at the depth of the card's hyper run when
# it removed genuine clients (1,200-1,500 samples a client); the card's
# run (chip_smoke.py phase 10) now trains 600-750
CONFIG4_CUT = dict(clients=100, attackers=25, rounds=3, num_data_range=(1200, 1500), epochs=2,
                   batch_size=128, train_size=20000)


def _hparams(module, seed: int = 1) -> dict:
    """Seeded float64 hypernetwork parameters from the init distributions
    (embeddings N(0, 1), the rest U(+-1/sqrt(fan_in)))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(0))["params"]
    return {name: ({"embedding": rng.standard_normal(leaves["embedding"].shape)}
                   if name == "embeddings" else
                   {k: rng.uniform(-1, 1, x.shape) / np.sqrt(leaves["kernel"].shape[0])
                    for k, x in leaves.items()})
            for name, leaves in shapes.items()}


def _draws(rng, clients: int, pool: int, lo: int, hi: int, epochs: int, jgroups, genuine,
           active: np.ndarray) -> RoundDraws:
    """The draws of JAX's hyper round on key ``rng`` (hyper.py:99-164),
    leaks with replacement over the active genuine clients."""
    G = len(genuine)
    leak_k = max(int(0.5 * G), 1)
    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, clients, pool, lo, hi)
    act = active[genuine].astype(np.float32)
    # float32 as the round computes it (the Gumbel draw takes p's dtype)
    leak_p = jnp.asarray(act / max(act.sum(), 1.0), jnp.float32)
    leaks = []
    for gi, grp in enumerate(jgroups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(as_t(np.stack([jax.random.choice(jax.random.split(key)[0], G,
                                                      (min(leak_k, G),), replace=True, p=leak_p)
                                    for key in keys])))
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)), sizes=as_t(sizes),
                      perms=jax_perms(jax.random.split(k_train, clients), epochs, hi),
                      dropout_seed=0, leaks=tuple(leaks))


def both_hyper_runs(clients: int, attackers: int, rounds: int, num_data_range: tuple,
                    epochs: int, batch_size: int, train_size: int, workdir: str) -> list[dict]:
    """``rounds`` hyper rounds of each package with the detector on, as
    the module doc says.  Returns per round both packages' ``ok``,
    removals, active count and the largest embedding gap."""
    lo, hi = num_data_range
    shared = dict(total_clients=clients, mode="hyper", model="TransformerModel",
                  data_name="ICU", num_data_range=num_data_range, epochs=epochs,
                  batch_size=batch_size, train_size=train_size, test_size=16, genuine_rate=0.5,
                  hyper_lr=0.001, clip_grad_norm=1.0, lr=0.004)
    lie = dict(mode="LIE", num_clients=attackers, attack_round=2, args=(0.74,))
    detection = dict(enable=True, start_round=2, cosine_search=5)
    jcfg = JaxConfig(**shared, prng_impl="threefry2x32", attacks=(JaxAttackSpec(**lie),),
                     hyper_detection=JaxHyperDetectionConfig(**detection),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**shared, attacks=(AttackSpec(**lie),),
                  hyper_detection=HyperDetectionConfig(**detection))
    hd = jcfg.hyper_detection
    assert (hd.eps, hd.n_components, hd.min_samples) == (0.007, 3, 3)
    detector_args = (hd.cosine_search, hd.n_components, hd.eps, hd.min_samples, hd.start_round)
    train_np = as_dtype(jax_get_dataset("ICU", "train", train_size, 1), np.float64)
    jgroups, genuine = jround.build_attack_groups(jcfg)
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert tgenuine == genuine and [g.indices for g in tgroups] == [g.indices for g in jgroups]
    G = len(genuine)

    with jax.enable_x64(True):
        jmodel = jicu.TransformerModel()
        jt = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 7)),
                            jnp.zeros((1, 16)))["params"]
        module, apply = jax_make_hypernetwork(jt, clients)
        hp = jax.tree.map(jnp.asarray, _hparams(module))
        step, generate_all = jax_build_hyper_round(
            JaxDropoutOff(jmodel), jcfg, {k: jnp.asarray(v) for k, v in train_np.items()},
            jgroups, genuine, apply)
        step, generate_all = jax.jit(step), jax.jit(generate_all)
        update, tx = jax_build_hyper_update(jcfg, apply, clients)
        update = jax.jit(update)
        jopt = tx.init(hp)
        jprev = jax.tree.map(lambda s: jnp.zeros((G,) + s.shape, jnp.float64), jt)
    jdet = jdefenses.HyperDetector(clients, *detector_args,
                                   save_path=os.path.join(workdir, "jax.npy"))

    tmpl = get_model("TransformerModel").init(torch.Generator().manual_seed(0))
    hnet = make_hypernetwork("HyperNetwork", tmpl, clients)
    tstep = build_hyper_round(dropout_off(get_model("TransformerModel")), tcfg,
                              {k: torch.from_numpy(v) for k, v in train_np.items()},
                              tgroups, tgenuine, hnet)
    tupdate, topt_init = build_hyper_update(tcfg, hnet)
    flat = hnet_params_from_jax(jax.tree.map(np.asarray, hp), hnet, dtype=torch.float64)
    topt = topt_init.init(flat)
    tprev = pt.tree_map(lambda x: torch.zeros((G,) + tuple(x.shape), dtype=torch.float64), tmpl)
    tdet = defenses.HyperDetector(clients, *detector_args,
                                  save_path=os.path.join(workdir, "port.npy"))

    jactive = np.ones(clients)
    tactive = torch.ones(clients, dtype=torch.float64)
    jhave = thave = False
    key = jax.random.key(7, impl="threefry2x32")
    out = []
    for b in range(1, rounds + 1):
        rng = jax.random.fold_in(key, b)
        with jax.enable_x64(True):
            stacked, sizes, jnew, jok, _ = step(hp, jprev, jnp.asarray(jhave),
                                                jnp.asarray(jactive), rng, jnp.asarray(b))
            jok, jremoved, jemb = bool(jok), [], None
            if jok:
                new_hp, new_opt = update(hp, jopt, stacked,
                                         jnp.asarray(jactive) * (sizes > 0))
                jemb = np.asarray(generate_all(new_hp)[1])
                selected = [int(i) for i in np.flatnonzero(jactive > 0)]
                jremoved = jdet.observe(b, selected, jemb[selected])
                if jremoved:
                    jactive[jremoved] = 0.0
                else:
                    hp, jopt = new_hp, new_opt
                jhave = True
            jprev = jnew
            # under x64, as the JAX round drew them
            draws = _draws(rng, clients, train_size, lo, hi, epochs, jgroups, genuine,
                           tactive.numpy())
        stacked, sizes, tnew, tok, _ = tstep(flat, tprev, thave, tactive, draws, b)
        tok, tremoved, temb = bool(tok), [], None
        if tok:
            new_flat, new_opt = tupdate(flat, topt, stacked, tactive * (sizes > 0))
            temb = hnet.generate_all(new_flat)[1].numpy()
            selected = torch.nonzero(tactive > 0)[:, 0].tolist()
            tremoved = tdet.observe(b, selected, temb[selected])
            if tremoved:
                tactive[tremoved] = 0.0
            else:
                flat, topt = new_flat, new_opt
            thave = True
        tprev = tnew
        out.append({"round": b, "ok": (jok, tok), "removed": (jremoved, tremoved),
                    "active": (int(jactive.sum()), int(tactive.sum())),
                    "attackers_removed": (sum(c in jgroups[0].indices for c in jremoved),
                                          sum(c in tgroups[0].indices for c in tremoved)),
                    "emb_gap": (float(np.abs(jemb - temb).max())
                                if jemb is not None and temb is not None else None)})
    return out


def test_hyper_detector_removals_match_jax(tmp_path):
    rounds = both_hyper_runs(**SMALL, workdir=str(tmp_path))
    for r in rounds:
        assert r["ok"][0] == r["ok"][1] is True, r
        assert r["removed"][0] == r["removed"][1], r
        assert r["emb_gap"] <= EMB_TOL, r
    assert [r["active"][0] for r in rounds] == [r["active"][1] for r in rounds]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--clients", type=int, choices=(20, 100), default=100,
                        help="20: the tier-1 cut; 100: config 4 (cut)")
    args = parser.parse_args(argv)
    cut = SMALL if args.clients == 20 else CONFIG4_CUT
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        rounds = both_hyper_runs(**cut, workdir=workdir)
    for r in rounds:
        print(f"round {r['round']}: ok JAX {r['ok'][0]} port {r['ok'][1]}; removed JAX "
              f"{r['removed'][0]} port {r['removed'][1]} (attackers among them: JAX "
              f"{r['attackers_removed'][0]}, port {r['attackers_removed'][1]}); active JAX "
              f"{r['active'][0]} port {r['active'][1]}; embedding gap {r['emb_gap']}")
    same = all(r["removed"][0] == r["removed"][1] and r["ok"][0] == r["ok"][1] for r in rounds)
    print(f"{cut}: removals equal in every round: {same}; {time.perf_counter() - t0:.1f} s")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
