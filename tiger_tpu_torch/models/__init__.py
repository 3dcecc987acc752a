"""Physics models of the port (DummyModel, Model 200, Model 204) and the uid registry."""

from __future__ import annotations

import dataclasses

from tiger_tpu_torch.models.base import Model
from tiger_tpu_torch.models.dummy import DummyModel
from tiger_tpu_torch.models.model200 import Model200
from tiger_tpu_torch.models.model204 import PARAM_FIELDS, Y0_COMMON, Model204

_REGISTRY = {
    DummyModel.UID: DummyModel,
    Model200.UID: Model200,
    Model204.UID: Model204,
}


def register_model(cls) -> None:
    """Register a model class under its UID."""
    _REGISTRY[cls.UID] = cls


def get_model(uid: int, **kwargs) -> Model:
    """Instantiate the model registered under ``uid``.

    ``kwargs`` are passed through when the model's dataclass declares the
    field and dropped otherwise, so ``run`` can offer them uniformly
    (``doy0``, the start date's day of year, which Model 200 reads and
    Model 204 does not).
    """
    try:
        cls = _REGISTRY[uid]
    except KeyError:
        raise KeyError(f"No model registered with uid {uid}; known: {sorted(_REGISTRY)}")
    names = {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
    return cls(**{k: v for k, v in kwargs.items() if k in names})


__all__ = [
    "Model",
    "DummyModel",
    "Model200",
    "Model204",
    "PARAM_FIELDS",
    "Y0_COMMON",
    "get_model",
    "register_model",
]
