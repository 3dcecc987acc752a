"""Physics models of the port: DummyModel and Model 204."""

from __future__ import annotations

from tiger_tpu_torch.models.base import Model
from tiger_tpu_torch.models.dummy import DummyModel
from tiger_tpu_torch.models.model204 import PARAM_FIELDS, Y0_COMMON, Model204

__all__ = ["Model", "DummyModel", "Model204", "PARAM_FIELDS", "Y0_COMMON"]
