"""Name-keyed model registry: the port's copy of
``attackfl_tpu/registry.py`` (the reference resolves the config's
``model:`` string by name, server.py:139-142)."""

from __future__ import annotations

from typing import Callable

MODEL_REGISTRY: dict[str, Callable] = {}


def register_model(name: str) -> Callable:
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a registered model by name."""
    import attackfl_tpu_torch.models  # noqa: F401  (registers the models)

    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Model name '{name}' is not valid. Registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
