"""Stage contracts: Transformer / Estimator, the column-role mixins, and the
device-stage protocol the planner fuses (own copy of the subset of
``mmlspark_tpu.core.stage`` that the port's stages use; the pre-flight
analyzer's schema hooks are not part of it)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.data.table import DataTable

_UID_COUNTER = itertools.count()


class PipelineStage(Params):
    """Base of every stage. Named, parameterized, persistable."""

    def __init__(self, **kwargs: Any):
        self._post_init()
        super().__init__(**kwargs)

    def _post_init(self) -> None:
        # split from __init__ so deserialization can bypass param validation
        if getattr(self, "_uid", None) is None:
            self._uid = f"{type(self).__name__}_{next(_UID_COUNTER)}"

    @property
    def uid(self) -> str:
        return self._uid

    def save(self, path: str, overwrite: bool = True) -> None:
        from mmlspark_tpu_torch.core import serialize
        serialize.save_stage(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from mmlspark_tpu_torch.core import serialize
        return serialize.load_stage(path)


class Transformer(PipelineStage):
    """A stage mapping DataTable → DataTable."""

    def transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError

    def __call__(self, table: DataTable) -> DataTable:
        return self.transform(table)


class Estimator(PipelineStage):
    """A stage that fits on a DataTable and yields a Transformer (model)."""

    def fit(self, table: DataTable) -> Transformer:
        raise NotImplementedError

    def fit_transform(self, table: DataTable) -> DataTable:
        return self.fit(table).transform(table)


class HasInputCol:
    input_col = Param(default="input", doc="name of the input column",
                      type_=str)


class HasOutputCol:
    output_col = Param(default="output", doc="name of the output column",
                       type_=str)


class HasDevice:
    device = Param(
        default=None, type_=str,
        doc="device a fused segment holding this stage runs on: None = "
            "'cuda' (raises without a card), or 'cpu' when asked for")


# ---- device-resident execution (the pipeline-fusion protocol) ----

@dataclasses.dataclass(frozen=True)
class ArrayMeta:
    """Shape/dtype contract for one column batched as a device tensor.

    ``shape`` is the per-row shape (the batch axis is implicit), ``dtype``
    a numpy dtype string, and ``is_image`` marks stacked HWC image structs
    (whose host form is a column of image dicts)."""

    shape: tuple
    dtype: str
    is_image: bool = False


@dataclasses.dataclass
class DeviceOp:
    """A stage's columnwise device computation.

    ``fn(params, x)`` maps a ``[B, *in_meta.shape]`` tensor already on the
    target device to ``[B, *out_meta.shape]`` on it. The planner chains
    adjacent ops into ONE forward per minibatch, so ``fn`` must not move
    data to the host. ``params`` (a module, tensors, numpy arrays, or
    nested lists/tuples/dicts of them) is placed on the device once per
    compiled segment (:func:`mmlspark_tpu_torch.core.plan.place`);
    stateless ops keep the default ``()``."""

    fn: Callable
    out_meta: ArrayMeta
    params: Any = ()


class DeviceStage:
    """Capability mixin: a stage that can describe its computation as a
    columnwise tensor → tensor function, letting the planner
    (:mod:`mmlspark_tpu_torch.core.plan`) keep data on the device across
    stage boundaries instead of paying a host round trip per stage.

    ``device_fn`` returning ``None`` (an unsupported op list, dtype or
    shape) keeps the stage's host ``transform``, with the same semantics.
    Device math must match the host path to the tolerance the parity
    tests state."""

    def device_input_col(self) -> str | None:
        """The single column the device computation consumes (None = this
        stage cannot run on the device in its current configuration)."""
        return getattr(self, "input_col", None)

    def device_output_col(self) -> str | None:
        """The column the device computation produces."""
        return getattr(self, "output_col", None)

    def device_cache_token(self) -> Any:
        """A cheap fingerprint of the configuration the device computation
        depends on; a changed token invalidates the planner's cached
        segment. The default covers stages fully described by their simple
        params; stages with complex params (models) override it."""
        vals = self._simple_param_values() if hasattr(
            self, "_simple_param_values") else {}
        return tuple(sorted((k, repr(v)) for k, v in vals.items()))

    def device_fn(self, meta: ArrayMeta) -> DeviceOp | None:
        """This stage's computation on a column of ``meta`` layout, or
        ``None`` to decline (host path)."""
        return None

    def device_emit(self, table: DataTable, values: Any,
                    meta: ArrayMeta, ctx: dict) -> DataTable:
        """Write the fused run's fetched output (``values``, shaped ``[N,
        *meta.shape]``) into the table as this stage's host ``transform``
        would. ``ctx`` carries segment-entry context (image paths)."""
        out = values if values.ndim == 1 else list(values)
        return table.with_column(self.device_output_col(), out)
