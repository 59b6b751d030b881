"""The ICU CNNModel and RNNModel of the port against the JAX package;
this file runs the tests of tests/_torch_port_icu_suite.py on CNNModel,
tests/test_torch_port_models_rnn.py on RNNModel.

Same numpy-made inputs into both packages; params are the port's init
nudged by a seeded 0.05, the same arrays on both sides.  Tolerances: the
eval-mode forward at full width 1e-5 (float32, another summation order);
one minibatch's float32 loss at 1e-6 and gradient at 1e-5 of its largest
magnitude; one local update of every client 2e-4 on the params and 1e-4
on the loss after two epochs of clipped Adam; the round at the
tolerances of tests/test_torch_port_round.py (trained rows 2e-4, LIE rows
1e-5, aggregate 2e-4, AUC 1e-3).

The CNN's local update and round run in float64 in both packages (JAX
under ``enable_x64``; its loss still rounds the model's output to
float32).  In float32 the two trajectories part by far more than float32
rounding: Adam's first step from m = v = 0 is lr * g / (|g| + 1e-8), so
a gradient near 1e-8, where float32 noise in another summation order is
of the same size, moves a parameter by up to lr = 0.004 one way or the
other, and ReLU boundaries carry that on.  The CNN's ReLUs leave such
gradients (20 of vitals_conv3's kernel entries below 1e-7 but not 0 at
the first step, whose gradients agree to 5e-8): after two epochs the
float32 rows differed by 1.1e-2 and the loss by 2.3e-4 (measured); in
float64 by 5.0e-6 and 1.1e-7.  flax's GRU cannot run in float64 (its
carry is made float32 whatever the inputs), so the RNN's stay float32,
where the same mechanism parts the rows by 3.3e-5 to 2.0e-4 over seeds
0-3 (the loss by at most 8.3e-7): its params are held at 5e-4, not 2e-4.
The local update is held against the JAX package's
``build_local_update`` as its round step runs it (vmapped over clients,
the round's keys), so one JAX compile serves both checks.
"""

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from _torch_port_icu_suite import (  # noqa: F401  (collected here)
    rounds, train_np,
    test_tree_matches_jax_names_and_shapes,
    test_init_follows_flax_distributions,
    test_forward_matches_flax,
    test_mask_specs,
    test_one_step_loss_and_gradient_match_jax,
    test_local_update_matches_jax,
    test_round_matches_jax,
    test_simulator_runs_on_cpu,
)
from attackfl_tpu_torch.models.layers import adaptive_avg_pool1d


@pytest.fixture(scope="module")
def name():
    return "CNNModel"


def test_adaptive_pool_bins_overlap():
    """7 -> 4 positions: bins [0, 2), [1, 4), [3, 6), [5, 7), as torch's
    AdaptiveAvgPool1d (JAX package layers.py:16-29)."""
    x = torch.arange(7, dtype=torch.float32).reshape(1, 1, 7)
    assert adaptive_avg_pool1d(x, 4).flatten().tolist() == [0.5, 2.0, 4.0, 5.5]
    assert torch.equal(adaptive_avg_pool1d(x, 4), torch.nn.functional.adaptive_avg_pool1d(x, 4))
