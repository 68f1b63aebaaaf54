"""TorchModel — batched DNN inference as a pipeline stage.

The port of ``mmlspark_tpu/models/jax_model.py`` (``coerce_input_matrix``,
``JaxModel``) on a single device:

* input coercion is one vectorized host copy into ``[N, *input_spec]``;
  uint8 sources stay uint8 (a quarter of the host→device bytes) and are
  upcast to float32 on the device, before the bundle's preprocessing;
* the module moves to the device once (:func:`plan.place`) and runs in
  ``eval`` mode under ``torch.inference_mode``;
* minibatches are padded to a fixed shape and pipelined by
  :mod:`mmlspark_tpu_torch.core.plan`, with one device→host fetch per
  minibatch;
* the output node is selected by name or index;
* as a :class:`~mmlspark_tpu_torch.core.stage.DeviceStage`, the same
  forward is an op the planner fuses with its neighbours, and the one the
  serving entry (``plan.transform_async``) dispatches.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.logging_utils import get_logger, timed
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.schema import is_image_column
from mmlspark_tpu_torch.core.stage import (
    ArrayMeta, DeviceOp, DeviceStage, HasDevice, HasInputCol, HasOutputCol,
    Transformer,
)
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.bundle import (
    PREPROCESSORS, ModelBundle, meta_copy,
)

_log = get_logger(__name__)

DEFAULT_MINIBATCH = plan.DEFAULT_MINIBATCH


def coerce_input_matrix(table: DataTable, column: str,
                        input_spec: tuple) -> np.ndarray:
    """Coerce an input column to a ``[N, *input_spec]`` array (uint8 or
    float32).

    The planner's entry coercion (``plan._entry_meta``/``_coerce_entry``)
    comes first, so a column that batch transform, serving and a fused
    segment all accept is coerced the one same way. What it declines
    takes the host rule: image-struct columns (ragged or mixed-dtype rows
    filled row by row; uint8 only when every row is uint8), vector columns
    (the first row's dtype picks uint8 or float32) and scalar numeric
    columns. Each is reshaped to the model spec."""
    meta = plan._entry_meta(table, column)
    coerced = (plan._coerce_entry(table, column, meta)
               if meta is not None else None)
    if coerced is not None:
        batch = coerced[0]
    elif is_image_column(table, column):
        # a lone float row must not be truncated into a uint8 buffer
        datas = [np.asarray(r["data"]) for r in table[column]]
        dtype = (np.uint8 if all(d.dtype == np.uint8 for d in datas)
                 else np.float32)
        batch = np.empty((len(datas),) + datas[0].shape, dtype=dtype)
        for i, d in enumerate(datas):
            batch[i] = d
    else:
        col = table[column]
        dtype = (np.uint8 if col.dtype == object
                 and np.asarray(col[0]).dtype == np.uint8 else np.float32)
        batch = table.column_matrix(column, dtype=dtype)
    want = (len(table),) + tuple(input_spec)
    if batch.shape != want:
        if int(np.prod(batch.shape)) != int(np.prod(want)):
            raise ValueError(
                f"column {column!r} has shape {batch.shape[1:]} per row; "
                f"model expects {tuple(input_spec)}")
        batch = batch.reshape(want)
    return batch


def output_meta(module: torch.nn.Module, forward: Callable,
                meta: ArrayMeta) -> ArrayMeta:
    """The per-row layout ``forward(module, x)`` gives for one row of
    ``meta``, traced on the meta device (no data, no kernel: the
    counterpart of ``jax.eval_shape``) on :func:`meta_copy` of the module,
    so the weights are neither copied nor touched. The kernels' wrappers
    take their plain version on meta tensors, whatever route the module
    asks for."""
    shadow = meta_copy(module)
    x = torch.empty((1,) + tuple(meta.shape), dtype=getattr(torch, meta.dtype),
                    device="meta")
    with torch.inference_mode():
        out = forward(shadow, x)
    return ArrayMeta(tuple(out.shape[1:]), str(out.dtype).split(".")[-1])


class TorchModel(Transformer, DeviceStage, HasInputCol, HasOutputCol,
                 HasDevice):
    """Applies a bundle's module to an input column, in minibatches."""

    model = Param(default=None, doc="ModelBundle to apply", is_complex=True)
    minibatch_size = Param(
        default=DEFAULT_MINIBATCH, doc="device minibatch size", type_=int,
        validator=Param.gt(0))
    output_node = Param(
        default=None, doc="output node to select, by name", type_=str)
    output_node_index = Param(
        default=None, doc="output node to select, by index", type_=int)

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

    def _forward(self, bundle: ModelBundle) -> Callable:
        """``fwd(module, x)``: rows of any layout with the spec's element
        count → the selected node; uint8 ships thin and computes as f32,
        then the bundle's preprocessing."""
        spec = tuple(bundle.input_spec)
        node = self._node(bundle)
        pre = PREPROCESSORS[bundle.preprocess] if bundle.preprocess else None

        def fwd(module: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
            x = x.reshape((x.shape[0],) + spec)
            if x.dtype == torch.uint8:
                x = x.float()
            if pre is not None:
                x = pre(x)
            return module(x, output=node)

        return fwd

    # -- DeviceStage protocol (core.plan) --

    def device_cache_token(self) -> Any:
        bundle = self.model
        return (None if bundle is None else
                (id(bundle.module), bundle.preprocess,
                 tuple(bundle.input_spec)),
                self.input_col, self.output_col, self.output_node,
                self.output_node_index, self.minibatch_size, self.device)

    def device_fn(self, meta: ArrayMeta) -> DeviceOp | None:
        """The forward ``transform`` runs, as a composable op whose params
        are the module. Declines on a per-row size mismatch, so the host
        path raises its shape error."""
        bundle = self.model
        if bundle is None:
            return None
        if int(np.prod(meta.shape)) != int(np.prod(bundle.input_spec)):
            return None
        fwd = self._forward(bundle)
        return DeviceOp(fwd, output_meta(bundle.module, fwd, meta),
                        params=bundle.module)

    def transform(self, table: DataTable) -> DataTable:
        bundle = self._bundle()
        device = resolve_device(self.device)
        if len(table) == 0:
            return table.with_column(self.output_col, [])
        label = f"TorchModel[{bundle.name}:{self._node(bundle)}]"
        with timed(label, _log, len(table)):
            batch = coerce_input_matrix(table, self.input_col,
                                        bundle.input_spec)
            fwd = self._forward(bundle)

            def forward(module, x):
                with torch.inference_mode():
                    return fwd(module, x)

            out = plan.pipeline_minibatches(
                forward, plan.place(bundle.module, device), batch,
                min(int(self.minibatch_size), len(batch)), device)[0]
        values: Any = out if out.ndim == 1 else list(out)
        return table.with_column(self.output_col, values)
