"""Stage contracts: Transformer, the column-role mixins, and the device-stage
protocol the plan dispatches (own copy of the subset of
``mmlspark_tpu.core.stage`` that the model stage uses)."""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.data.table import DataTable


class Transformer(Params):
    """A stage mapping DataTable → DataTable."""

    def transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError


class HasInputCol:
    input_col = Param(default="input", doc="name of the input column",
                      type_=str)


class HasOutputCol:
    output_col = Param(default="output", doc="name of the output column",
                       type_=str)


class DeviceStage:
    """A stage whose work runs as one device forward per minibatch, which
    :mod:`mmlspark_tpu_torch.core.plan` dispatches asynchronously.

    The plan owns the crossings (host batch → device → host) and the
    in-flight window; the stage says what crosses: ``device_entry`` makes
    the host batch, ``device_forward`` runs on the device tensor,
    ``device_emit`` writes the host result back into the table."""

    minibatch_size: Any

    def target_device(self) -> Any:
        """The ``torch.device`` the forward runs on."""
        raise NotImplementedError

    def device_entry(self, table: DataTable) -> np.ndarray:
        """The table's input as one ``[N, ...]`` host array."""
        raise NotImplementedError

    def device_forward(self, x: Any) -> Any:
        """The forward over one minibatch already on the target device."""
        raise NotImplementedError

    def device_emit(self, table: DataTable, out: np.ndarray) -> DataTable:
        """``table`` with the ``[N, ...]`` host result written in."""
        raise NotImplementedError
