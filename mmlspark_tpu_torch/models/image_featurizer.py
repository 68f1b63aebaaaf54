"""ImageFeaturizer — transfer-learning featurization from zoo models (the
port of ``mmlspark_tpu/models/image_featurizer.py`` without
``set_model_from_repo``).

Resize the image to the model's input size, run the truncated network and
emit the activation vector. ``cut_output_layers`` counts named output
nodes dropped from the end: 0 keeps the head (logits), 1 gives the
penultimate features. Images are BGR HWC uint8, as ``make_image`` holds
them; the bundle's preprocessing runs on them as the JAX package runs it.
"""

from __future__ import annotations

from typing import Any

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import (
    ArrayMeta, DeviceOp, DeviceStage, HasDevice, HasInputCol, HasOutputCol,
    Transformer,
)
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.stages.image import ImageTransformer


class ImageFeaturizer(Transformer, DeviceStage, HasInputCol, HasOutputCol,
                      HasDevice):
    """Resize to the model's input size and run a truncated forward
    (``cut_output_layers`` picks the node among the bundle's
    ``output_names``)."""

    input_col = Param(default="image", doc="input image column", type_=str)
    output_col = Param(default="features", doc="output feature column",
                       type_=str)
    model = Param(default=None, doc="ModelBundle to featurize with",
                  is_complex=True)
    cut_output_layers = Param(
        default=1, doc="number of output nodes cut from the end "
        "(0 = keep the full head)", type_=int, validator=Param.ge(0))
    minibatch_size = Param(default=None, doc="device minibatch size",
                           type_=int)

    def set_model_by_name(self, name: str, **kwargs: Any) -> "ImageFeaturizer":
        """A zoo bundle (``models/zoo.py``), built on this stage's device
        unless ``kwargs`` names one."""
        from mmlspark_tpu_torch.models.zoo import get_model
        kwargs.setdefault("device", self.device)
        self.set(model=get_model(name, **kwargs))
        return self

    def _resolve_cut_node(self, bundle: ModelBundle) -> str:
        cut = self.cut_output_layers
        names = bundle.output_names
        if cut >= len(names):
            raise ValueError(
                f"cut_output_layers={cut} but model has only "
                f"{len(names)} output nodes {names}")
        return names[len(names) - 1 - cut]

    def _stages(self) -> list:
        """The resize → forward stage pair, built once per configuration so
        the planner's segment cache (keyed by stage identity) stays warm
        across transform calls."""
        bundle: ModelBundle = self.model
        if bundle is None:
            raise ValueError("ImageFeaturizer: no model set")
        h, w = bundle.input_spec[0], bundle.input_spec[1]
        key = (id(bundle), h, w, self._resolve_cut_node(bundle),
               self.minibatch_size, self.input_col, self.output_col,
               self.device)
        cached = self.__dict__.get("_stage_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        rt = ImageTransformer(input_col=self.input_col,
                              output_col=self.input_col,
                              device=self.device).resize(h, w)
        tm = TorchModel(input_col=self.input_col, output_col=self.output_col,
                        output_node=self._resolve_cut_node(bundle),
                        device=self.device)
        if self.minibatch_size is not None:
            tm.set(minibatch_size=self.minibatch_size)
        tm.set(model=bundle)
        self.__dict__["_stage_cache"] = (key, [rt, tm])
        return [rt, tm]

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in ("_stage_cache", "_plan_cache", "_plan_lock"):
            d.pop(k, None)
        return d

    def transform(self, table: DataTable) -> DataTable:
        # resize + truncated forward through the planner: on a table of
        # uniform uint8 images they fuse into ONE forward per minibatch
        # (one upload of the raw pixels, one fetch round); anything the
        # planner declines runs the same two stages on the host path
        from mmlspark_tpu_torch.core import plan
        return plan.execute_stages(self._stages(), table, cache_host=self)

    # ---- DeviceStage protocol: resize ∘ forward as one op, so an
    #      ImageFeaturizer inside a larger pipeline fuses with its
    #      neighbours. Declines when the resize would change the image's
    #      dimensions: transform() also writes the resized image column,
    #      which a fused op that skipped it would not ----

    def device_cache_token(self) -> Any:
        bundle = self.model
        return (None if bundle is None else
                (id(bundle.module), bundle.preprocess,
                 tuple(bundle.input_spec)),
                self.input_col, self.output_col, self.cut_output_layers,
                self.minibatch_size, self.device)

    def device_fn(self, meta: ArrayMeta) -> DeviceOp | None:
        bundle: ModelBundle = self.model
        if bundle is None or not meta.is_image or len(meta.shape) != 3:
            return None
        h, w = bundle.input_spec[0], bundle.input_spec[1]
        if tuple(meta.shape[:2]) != (h, w):
            return None
        rt, tm = self._stages()
        resize_op = rt.device_fn(meta)
        if resize_op is None:
            return None
        fwd_op = tm.device_fn(resize_op.out_meta)
        if fwd_op is None:
            return None

        def fn(params: tuple, x):
            return fwd_op.fn(params[1], resize_op.fn(params[0], x))

        return DeviceOp(fn, fwd_op.out_meta,
                        params=(resize_op.params, fwd_op.params))
