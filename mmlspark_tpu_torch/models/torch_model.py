"""TorchModel — batched DNN inference as a pipeline stage.

The port of ``mmlspark_tpu/models/jax_model.py`` (``coerce_input_matrix``,
``JaxModel``) on a single device:

* input coercion is one vectorized host copy into ``[N, *input_spec]``;
  uint8 sources stay uint8 (a quarter of the host→device bytes) and are
  upcast to float32 on the device, before the bundle's preprocessing;
* the module moves to the device once per (module, device) and runs in
  ``eval`` mode under ``torch.inference_mode``;
* minibatches are padded to a fixed shape and pipelined by
  :mod:`mmlspark_tpu_torch.core.plan` (the same dispatch path the server
  takes), with one device→host fetch per minibatch;
* the output node is selected by name or index.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.logging_utils import get_logger, timed
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import (
    DeviceStage, HasInputCol, HasOutputCol, Transformer,
)
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.bundle import PREPROCESSORS, ModelBundle

_log = get_logger(__name__)

DEFAULT_MINIBATCH = 64


def coerce_input_matrix(table: DataTable, column: str,
                        input_spec: tuple) -> np.ndarray:
    """Coerce an input column to a ``[N, *input_spec]`` array: uint8 when
    the column's cells are uint8 arrays, float32 otherwise. Accepts vector
    columns (each cell reshaped to the spec) and scalar numeric columns."""
    col = table[column]
    if col.dtype == object:
        first = np.asarray(col[0]) if len(col) else None
        dtype = (np.uint8 if first is not None and first.dtype == np.uint8
                 else np.float32)
        batch = table.column_matrix(column, dtype=dtype)
    else:
        batch = table.column_matrix(column, dtype=np.float32)
    want = (len(table),) + tuple(input_spec)
    if batch.shape != want:
        if int(np.prod(batch.shape)) != int(np.prod(want)):
            raise ValueError(
                f"column {column!r} has shape {batch.shape[1:]} per row; "
                f"model expects {tuple(input_spec)}")
        batch = batch.reshape(want)
    return batch


class TorchModel(Transformer, DeviceStage, HasInputCol, HasOutputCol):
    """Applies a bundle's module to an input column, in minibatches."""

    model = Param(default=None, doc="ModelBundle to apply", is_complex=True)
    minibatch_size = Param(
        default=DEFAULT_MINIBATCH, doc="device minibatch size", type_=int,
        validator=Param.gt(0))
    output_node = Param(
        default=None, doc="output node to select, by name", type_=str)
    output_node_index = Param(
        default=None, doc="output node to select, by index", type_=int)
    device = Param(
        default=None, type_=str,
        doc="device to run on: None = 'cuda' (raises without a card), "
            "or 'cpu' when asked for explicitly")

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self._lock = threading.Lock()
        self._placed: tuple | None = None  # (module, device)

    def _bundle(self) -> ModelBundle:
        bundle = self.model
        if bundle is None:
            raise ValueError("TorchModel: no model set")
        return bundle

    def _node(self, bundle: ModelBundle) -> str:
        if self.output_node is not None:
            return bundle.resolve_output(self.output_node)
        if self.output_node_index is not None:
            return bundle.resolve_output(self.output_node_index)
        return bundle.resolve_output(None)

    def target_device(self) -> torch.device:
        return resolve_device(self.device)

    def _module(self, bundle: ModelBundle) -> torch.nn.Module:
        """The bundle's module on the target device: moved once (in place,
        as ``Module.to`` does), then reused by every call."""
        dev = self.target_device()
        with self._lock:
            placed = self._placed
            if placed is None or placed[0] is not bundle.module \
                    or placed[1] != dev:
                bundle.module.to(dev).eval()
                self._placed = (bundle.module, dev)
        return bundle.module

    # -- DeviceStage protocol (core.plan) --

    def device_entry(self, table: DataTable) -> np.ndarray:
        bundle = self._bundle()
        return coerce_input_matrix(table, self.input_col, bundle.input_spec)

    def device_forward(self, x: torch.Tensor) -> torch.Tensor:
        bundle = self._bundle()
        module = self._module(bundle)
        pre = PREPROCESSORS[bundle.preprocess] if bundle.preprocess else None
        with torch.inference_mode():
            if x.dtype == torch.uint8:  # shipped thin, computes as f32
                x = x.float()
            if pre is not None:
                x = pre(x)
            return module(x, output=self._node(bundle))

    def device_emit(self, table: DataTable, out: np.ndarray) -> DataTable:
        values: Any = out if out.ndim == 1 else list(out)
        return table.with_column(self.output_col, values)

    def transform(self, table: DataTable) -> DataTable:
        bundle = self._bundle()
        if len(table) == 0:
            return table.with_column(self.output_col, [])
        label = f"TorchModel[{bundle.name}:{self._node(bundle)}]"
        with timed(label, _log, len(table)):
            return plan.dispatch(self, table).result()
