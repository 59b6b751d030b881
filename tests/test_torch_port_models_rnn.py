"""The ICU RNNModel of the port against the JAX package: the tests of
tests/_torch_port_icu_suite.py on RNNModel, whose tolerances and their
reasons tests/test_torch_port_models_cnn.py states (the RNN's local update
and round run in float32, its params held at 5e-4), but the one-step
float32 check, which the float32 round already makes.
"""

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from _torch_port_icu_suite import (  # noqa: F401  (collected here)
    rounds, train_np,
    test_tree_matches_jax_names_and_shapes,
    test_init_follows_flax_distributions,
    test_forward_matches_flax,
    test_mask_specs,
    test_local_update_matches_jax,
    test_round_matches_jax,
    test_simulator_runs_on_cpu,
)


@pytest.fixture(scope="module")
def name():
    return "RNNModel"
