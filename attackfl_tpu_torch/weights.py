"""Carry parameters between the JAX package and the port.

The port keeps the flax names and the flax layout (see models/layers.py),
so the conversion is a copy leaf for leaf: ``params_from_jax`` takes the
JAX package's parameter tree as numpy arrays (any nested mapping, stacked
or not) and returns the port's tree of float32 tensors;
``params_to_jax`` is its inverse.  Both check names and shapes against the
port's model so a layout drift fails loudly instead of training garbage.
``hnet_params_from_jax`` and ``hnet_params_to_jax`` do the same for a
hypernetwork's parameters, which the port keeps as one flat vector
(``models/hyper.py``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from attackfl_tpu_torch.ops.pytree import tree_items
from attackfl_tpu_torch.registry import get_model


def _template_shapes(model_name: str) -> dict[str, tuple[int, ...]]:
    model = get_model(model_name)
    return {name.replace(".", "/"): tuple(p.shape)
            for name, p in model.named_parameters()}


def _walk(tree: Mapping, prefix: str = ""):
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


def _check(paths_shapes: dict[str, tuple[int, ...]], model_name: str) -> None:
    expected = _template_shapes(model_name)
    if set(paths_shapes) != set(expected):
        missing = sorted(set(expected) - set(paths_shapes))
        extra = sorted(set(paths_shapes) - set(expected))
        raise ValueError(f"parameter names differ: missing {missing}, extra {extra}")
    for path, shape in paths_shapes.items():
        # stacked trees carry leading client axes before the leaf's shape
        if tuple(shape[len(shape) - len(expected[path]):]) != expected[path]:
            raise ValueError(
                f"{path}: shape {tuple(shape)} does not end in {expected[path]}")


def params_from_jax(tree: Mapping, model_name: str = "TransformerModel",
                    device: torch.device | str = "cpu") -> dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's tree of tensors."""
    leaves = {path: np.asarray(value, dtype=np.float32) for path, value in _walk(tree)}
    _check({p: v.shape for p, v in leaves.items()}, model_name)
    out: dict[str, Any] = {}
    for path, value in leaves.items():
        *keys, leaf = path.split("/")
        node = out
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(value.copy()).to(device)
    return out


def params_to_jax(tree: dict[str, Any],
                  model_name: str = "TransformerModel") -> dict[str, Any]:
    """The port's tree -> nested dict of numpy arrays in the JAX layout."""
    leaves = {path: leaf.detach().cpu().numpy() for path, leaf in tree_items(tree)}
    _check({p: v.shape for p, v in leaves.items()}, model_name)
    out: dict[str, Any] = {}
    for path, value in leaves.items():
        *keys, leaf = path.split("/")
        node = out
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def hnet_params_from_jax(tree: Mapping, hnet, device: torch.device | str = "cpu",
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX package's hypernetwork parameter tree (numpy leaves) -> the
    port's flat vector for ``hnet`` (``models/hyper.py``), checked against
    ``hnet``'s head names and shapes (HyperNetwork's or CNNHyper's)."""
    tree = {path: torch.from_numpy(np.array(value)) for path, value in _walk(tree)}
    nested: dict[str, Any] = {}
    for path, value in tree.items():
        module, name = path.split("/")
        nested.setdefault(module, {})[name] = value.to(dtype)
    return hnet.from_tree(nested, device)


def hnet_params_to_jax(flat: torch.Tensor, hnet) -> dict[str, Any]:
    """The port's flat hypernetwork vector -> the flax tree of numpy
    arrays (head kernels ``(hidden, numel)``, as flax holds them)."""
    return {module: {name: leaf.detach().cpu().numpy().copy() for name, leaf in leaves.items()}
            for module, leaves in hnet.tree(flat).items()}
