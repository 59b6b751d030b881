"""The port's kernel validator (the port of ``scripts/tpu_validate_pallas.py``).

    python -m attackfl_tpu_torch.validate_kernels

Three checks on the card, at C=8 clients, batch 16, 64 samples, 2 epochs:

  (a) kernel K1 (``csrc/fused_step.cu``) with dropout off against the
      torch-autograd local update (``training/local.py``) with masks off,
      on the same seeded data, params and permutations: every client's
      params at 2e-4 max-abs, the loss at 1e-4 (the script's tolerances).
      Both start from a cold Adam state, whose first step moves a
      parameter by lr * g / (|g| + 1e-8): where the first gradient is
      near 1e-8, float32 rounding in g moves p by up to lr in any two
      float32 implementations.  So p is gated on the entries whose first
      clipped gradient, in float64, is at least 1e-6, and the difference
      on every entry is reported beside it (chip_smoke.py gates K1
      against its plain version the same way);
  (b) kernel K3 (``csrc/dropout_mask.cu``) at (256, 128), rates 0.1, 0.3
      and 0.5: values in {0, 1/(1-rate)}, keep rate within 4 sigma of
      1 - rate, mean within 2% of 1, and bit-equal to its plain version
      ``ops/fused_step.dropout_mask`` on the same keys;
  (c) K1 with dropout on: finite, ok, and more than 1e-6 away from the
      dropout-off params of (a) (the masks fire).

Prints one JSON line; exit code 0 when every check passes, 1 when one
fails, 2 when no CUDA device is visible.  The checks take a device, so the
tests run (a) on the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.models.icu import T_HEAD, TransformerModel
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops.pytree import tree_items, tree_leaves, tree_map
from attackfl_tpu_torch.training import local

C, B, N, EPOCHS, HI = 8, 16, 64, 2, 48
LR, CLIP, SEED = 0.004, 1.0, 9
PARAM_TOL, LOSS_TOL = 2e-4, 1e-4
GRAD_FLOOR = 1e-6
MASK_SHAPE = (256, 128)


def inputs(device) -> tuple[dict, dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seeded data [N], init params, and per-client indices, masks and
    per-epoch permutations."""
    rng = np.random.default_rng(1)
    data = {"vitals": rng.standard_normal((N, 7)), "labs": rng.standard_normal((N, 16)),
            "label": rng.random(N) > 0.5}
    data = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in data.items()}
    params = TransformerModel().init(torch.Generator().manual_seed(0), device)
    idx = np.stack([rng.permutation(N)[:HI] for _ in range(C)])
    perms = np.stack([[rng.permutation(HI) for _ in range(C)] for _ in range(EPOCHS)])
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)  # noqa: E731
    mask = torch.ones((C, HI), dtype=torch.bool, device=device)
    return data, params, as_t(idx), mask, as_t(perms)


def max_abs(a: dict, b: dict, where: dict | None = None) -> float:
    """max |a - b| over every leaf, restricted to the entries where
    ``where`` (a tree of bools) is true when it is given."""
    other = dict(tree_items(b))
    keep = dict(tree_items(where)) if where is not None else {}
    out = 0.0
    for path, x in tree_items(a):
        d = (x - other[path]).abs()
        if where is not None:
            d = d[keep[path]]
        if d.numel():
            out = max(out, float(d.max()))
    return out


def first_step_grads(device, dropout) -> dict:
    """|g| of every client's first clipped gradient, in float64: a tree
    of [C, ...] leaves."""
    data, params, idx, mask, perms = inputs(device)
    rows = torch.gather(idx, 1, perms[0])[:, :B]
    keys = fused_step.client_keys(SEED, 0, torch.arange(C, device=device))
    model = TransformerModel()
    masks = local.step_masks(keys, model.mask_specs([(B,)], dropout))
    loss_fn = local.make_loss_fn(model, "ICU")
    p64 = tree_map(lambda x: x.double(), params)
    grads = []
    for c in range(C):
        vitals, labs, label = (data[k][rows[c]].double() for k in ("vitals", "labs", "label"))
        mc = None if masks is None else [m[c].double() for m in masks]
        grads.append(torch.func.grad(loss_fn)(
            p64, (vitals, labs), label, mask[c, :B].double(), mc))
    g = tree_map(lambda *xs: torch.stack(xs), *grads)
    norm = torch.sqrt(sum(torch.sum(x.reshape(C, -1) ** 2, dim=1) for x in tree_leaves(g)))
    scale = torch.clamp(CLIP / norm, max=1.0)
    return tree_map(lambda x: (x * scale.reshape((C,) + (1,) * (x.ndim - 1))).abs(), g)


def train(device, dropout, fused: bool):
    data, params, idx, mask, perms = inputs(device)
    kw = dict(epochs=EPOCHS, batch_size=B, lr=LR, clip_grad_norm=CLIP, dropout=dropout)
    if fused:
        update = fused_step.build_fused_local_update(data, **kw)
    else:
        update = local.build_local_update(TransformerModel(), "ICU", data, **kw)
    return update(params, idx, mask, perms, SEED)


def check_autodiff_match(device="cuda") -> dict:
    """(a): K1 with dropout off equals the autograd update, all clients."""
    off = (0.0, 0.0, 0.0)
    kp, kok, kloss = train(device, off, fused=True)
    ap, aok, aloss = train(device, off, fused=False)
    g1 = first_step_grads(device, off)
    diff = max_abs(kp, ap, tree_map(lambda g: g >= GRAD_FLOOR, g1))
    dloss = float((kloss - aloss).abs().max())
    # the inert attention query/key leaves have exactly zero gradient
    live = [g[g > 0] for g in tree_leaves(g1)]
    return {"ok": bool(kok.all()) and bool(aok.all()) and diff < PARAM_TOL and dloss < LOSS_TOL,
            "max_abs_param_diff": diff, "max_abs_param_diff_all_entries": max_abs(kp, ap),
            "live_entries_below_grad_floor": sum(int((g < GRAD_FLOOR).sum()) for g in live),
            "live_entries": sum(g.numel() for g in live),
            "loss_diff": dloss, "new_params": kp}


def check_mask_statistics(device="cuda") -> dict:
    """(b): K3's values, keep rate and mean, and its bits against the
    plain version."""
    keys = fused_step.client_keys(42, 0, torch.arange(1, device=device))
    results: dict = {}
    all_ok = True
    for rate in (0.1, 0.3, 0.5):
        m = fused_step.fill_mask(keys, T_HEAD, *MASK_SHAPE, rate)
        bit_equal = torch.equal(m, fused_step.dropout_mask(keys, T_HEAD, *MASK_SHAPE, rate))
        scale = float(np.float32(1.0 / (1.0 - rate)))
        values_ok = bool(((m == 0.0) | (m == scale)).all())
        keep = float((m > 0).float().mean())
        sigma = (rate * (1 - rate) / m.numel()) ** 0.5
        keep_ok = abs(keep - (1 - rate)) < 4 * sigma
        mean = float(m.double().mean())
        mean_ok = abs(mean - 1.0) < 0.02
        results[f"rate_{rate}"] = {
            "keep_frac": keep, "expected": 1 - rate, "tol_4sigma": 4 * sigma,
            "mask_mean": mean, "values_ok": values_ok, "keep_ok": keep_ok,
            "mean_ok": mean_ok, "bit_equal_to_plain": bit_equal}
        all_ok &= values_ok and keep_ok and mean_ok and bit_equal
    results["ok"] = all_ok
    return results


def check_dropout_on_step(dropoff_params: dict, device="cuda") -> dict:
    """(c): K1 with dropout on trains, stays finite and actually drops."""
    new_p, ok, loss = train(device, (0.1, 0.1, 0.3), fused=True)
    finite = all(bool(torch.isfinite(x).all()) for _, x in tree_items(new_p))
    finite &= bool(torch.isfinite(loss).all())
    diff = max_abs(new_p, dropoff_params)
    return {"ok": bool(ok.all()) and finite and diff > 1e-6, "finite": finite,
            "max_abs_vs_dropout_off": diff, "mean_loss": float(loss.mean())}


def run_checks(device="cuda") -> dict:
    out: dict = {"device": torch.cuda.get_device_name(0) if device == "cuda" else device}
    a = check_autodiff_match(device)
    dropoff_params = a.pop("new_params")
    out["autodiff_match"] = a
    out["mask_statistics"] = check_mask_statistics(device)
    out["dropout_on_step"] = check_dropout_on_step(dropoff_params, device)
    out["ok"] = all(out[k]["ok"] for k in ("autodiff_match", "mask_statistics",
                                           "dropout_on_step"))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "skipped": True,
                          "reason": "no CUDA device is visible: the kernels run on the card"}))
        return 2
    resolve_device("cuda")
    out = run_checks("cuda")
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
