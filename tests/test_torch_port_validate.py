"""The port's kernel validator (attackfl_tpu_torch/validate_kernels.py),
its build cache and its entry points, on the CPU.

Here the validator's checks run through the kernels' plain versions: (a)
holds the plain version of K1 (``run_epoch_reference``) against the
torch-autograd update at the validator's own tolerances, 2e-4 on params
and 1e-4 on the loss (two epochs of clipped Adam in float32, summed in
another order).  The kernels themselves run only on the card
(tests/test_torch_port_kernel_cuda.py, chip_smoke.py).
"""

import shutil

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch import cli, validate_kernels
from attackfl_tpu_torch.ops import build, fused_step
from attackfl_tpu_torch.ops.pytree import tree_items

REPO_CONFIG = __file__.rsplit("/tests/", 1)[0] + "/config.yaml"


@pytest.fixture(scope="module")
def autodiff_match():
    return validate_kernels.check_autodiff_match("cpu")


def test_check_a_fused_matches_autograd_on_cpu(autodiff_match):
    """Gated on the entries whose first clipped gradient is at least 1e-6
    (the validator's docstring says why); those left out are well under
    1% of the live entries."""
    assert autodiff_match["max_abs_param_diff"] < validate_kernels.PARAM_TOL
    assert autodiff_match["loss_diff"] < validate_kernels.LOSS_TOL
    assert autodiff_match["live_entries_below_grad_floor"] < 0.01 * autodiff_match["live_entries"]
    assert autodiff_match["ok"]


def test_check_b_mask_statistics_on_cpu():
    out = validate_kernels.check_mask_statistics("cpu")
    assert out["ok"], out
    assert all(out[f"rate_{r}"]["bit_equal_to_plain"] for r in (0.1, 0.3, 0.5))


def test_check_c_dropout_on_step_on_cpu(autodiff_match):
    out = validate_kernels.check_dropout_on_step(autodiff_match["new_params"], "cpu")
    assert out["ok"] and out["finite"] and out["max_abs_vs_dropout_off"] > 1e-6


def test_first_step_grads_with_dropout_on():
    """The gate of (a) on the card test's inputs: with dropout on, the
    first gradient follows the step's masks."""
    off = validate_kernels.first_step_grads("cpu", (0.0, 0.0, 0.0))
    on = validate_kernels.first_step_grads("cpu", (0.1, 0.1, 0.3))
    diff = validate_kernels.max_abs(on, off)
    assert 0.0 < diff and all(bool(torch.isfinite(x).all()) for _, x in tree_items(on))
    assert next(tree_items(on))[1].dtype == torch.float64


def test_validator_exits_2_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert validate_kernels.main() == 2
    assert '"skipped": true' in capsys.readouterr().out


def test_library_name_tracks_shared_headers(tmp_path, monkeypatch):
    """An edited, added or removed ``csrc/*.cuh`` renames every library,
    so a stale build is never loaded."""
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    monkeypatch.setattr(build, "SRC_DIR", src)
    names = ("fused_step", "dropout_mask")
    before = {n: build.library_path(n) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = src / "dropout_hash.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in names}
    (src / "extra.cuh").write_text("#pragma once\n")
    added = {n: build.library_path(n) for n in names}
    for n in names:
        assert len({before[n], edited[n], added[n]}) == 3, n
    (src / "dropout_mask.cu").write_text("// edited\n")
    assert build.library_path("dropout_mask") != added["dropout_mask"]
    assert build.library_path("fused_step") == added["fused_step"]


def test_fill_mask_plain_on_cpu_and_checks_inputs():
    keys = fused_step.client_keys(5, 2, torch.arange(3))
    before = fused_step.fill_masks.launches
    got = fused_step.fill_mask(keys, 17, 8, 6, 0.1)
    assert torch.equal(got, fused_step.dropout_mask(keys, 17, 8, 6, 0.1))
    assert fused_step.fill_masks.launches == before
    with pytest.raises(ValueError, match="int64"):
        fused_step.fill_mask(keys.to(torch.int32), 17, 8, 6, 0.1)
    with pytest.raises(ValueError, match="empty"):
        fused_step.fill_mask(keys, 17, 0, 6, 0.1)
    with pytest.raises(ValueError, match="rate"):
        fused_step.fill_mask(keys, 17, 8, 6, 1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_step.fill_mask(keys.to("meta"), 17, 8, 6, 0.1)


def test_repo_config_runs_on_the_card_only(monkeypatch):
    """``python -m attackfl_tpu_torch run --config config.yaml`` (the
    default local_backend xla) now passes the slice check and asks for
    the card: without a CUDA device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--config", REPO_CONFIG])
