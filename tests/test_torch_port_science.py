"""The port's copies of the scenario science modules
(``attackfl_tpu_torch/science/outcomes.py`` and ``rank.py``) against the
JAX package's on the same records: the committed corpus of
``tests/test_science.py`` (three synthetic sweeps over (none + LIE +
Min-Max) x (krum, median, trimmed_mean) x seeds 1-3; ``flip`` collapses
krum), and a corpus with no ``none`` baseline.  Both packages' functions
are torch- and jax-free, so this file imports no JAX runtime.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from attackfl_tpu.science import outcomes as joutcomes
from attackfl_tpu.science import rank as jrank
from attackfl_tpu_torch.science import outcomes, rank

CORPUS = Path(__file__).resolve().parent / "data" / "science_corpus" / "ledger.jsonl"
SWEEPS = ("base-a", "base-b", "flip", None)


def _records() -> list[dict]:
    return [json.loads(line) for line in CORPUS.open()]


def _without_baseline() -> list[dict]:
    return [r for r in _records() if not str(r.get("cell", "")).startswith("none")]


@pytest.mark.parametrize("key", ["Min-Maxxkrum.s3", "nonexfedavg.s1", "LIExtrimmed_mean.s12",
                                 "garbage", "LIExmedian", "LIExmedian.sNaN"])
def test_parse_cell_key_as_jaxs(key):
    assert outcomes.parse_cell_key(key) == joutcomes.parse_cell_key(key)


@pytest.mark.parametrize("sweep", SWEEPS)
@pytest.mark.parametrize("corpus", [_records, _without_baseline])
def test_outcome_rows_as_jaxs(sweep, corpus):
    records = corpus()
    assert outcomes.outcome_rows(records, sweep_id=sweep) == \
        joutcomes.outcome_rows(records, sweep_id=sweep)
    assert outcomes.pick_quality_key(records) == joutcomes.pick_quality_key(records)
    assert outcomes.sweep_ids(records) == joutcomes.sweep_ids(records)
    rows = outcomes.outcome_rows(records, sweep_id=sweep)
    assert outcomes.format_outcomes(rows) == joutcomes.format_outcomes(rows)


@pytest.mark.parametrize("sweep", SWEEPS[:3])
def test_leaderboard_as_jaxs(sweep):
    rows = outcomes.outcome_rows(_records(), sweep_id=sweep)
    for n_boot in (50, 200):
        ours = rank.leaderboard(rows, sweep_id=sweep, n_boot=n_boot)
        assert ours == jrank.leaderboard(rows, sweep_id=sweep, n_boot=n_boot)
        assert rank.format_leaderboard(ours) == jrank.format_leaderboard(ours)
    assert rank.defense_scores(rows) == jrank.defense_scores(rows)
    assert rank.attack_scores(rows) == jrank.attack_scores(rows)


@pytest.mark.parametrize("pair", [("base-a", "base-a"), ("base-a", "base-b"),
                                  ("base-a", "flip")])
def test_rank_diff_as_jaxs(pair):
    old, new = (rank.leaderboard(outcomes.outcome_rows(_records(), sweep_id=s), sweep_id=s)
                for s in pair)
    ours = rank.rank_diff(old, new)
    assert ours == jrank.rank_diff(old, new)
    assert rank.format_diff(ours) == jrank.format_diff(ours)


@pytest.mark.parametrize("means", [{}, {1: 0.5}, {1: 0.1, 2: 0.2, 3: 0.4},
                                   {1: 0.3, 2: 0.3, 5: -0.1, 7: 0.9}])
def test_rank_statistics_as_jaxs(means):
    assert rank.bootstrap_ci(means) == jrank.bootstrap_ci(means)
    assert rank.seed_spread(means) == jrank.seed_spread(means)
    other = {str(k): v * v for k, v in means.items()}
    ours = {str(k): v for k, v in means.items()}
    assert rank.kendall_tau(ours, other) == jrank.kendall_tau(ours, other)
