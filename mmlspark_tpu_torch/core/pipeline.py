"""Pipeline / PipelineModel — ordered stage composition (the port of
``mmlspark_tpu/core/pipeline.py`` without the pre-flight analyzer's hooks).

``Pipeline.fit`` walks the stages: estimators are fitted on the running
table and replaced by their models; transformers pass through.
``PipelineModel.transform`` runs through the planner
(:mod:`mmlspark_tpu_torch.core.plan`), which fuses maximal runs of device
stages into one forward per minibatch.
"""

from __future__ import annotations

from typing import Any, Sequence

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import (
    Estimator, PipelineStage, Transformer,
)
from mmlspark_tpu_torch.data.table import DataTable


class Pipeline(Estimator):
    """Ordered composition of stages fit as one estimator: estimator
    stages are fit in sequence on the progressively transformed table; the
    result is a :class:`PipelineModel` of fitted transformers."""

    stages = Param(default=None, doc="ordered list of pipeline stages",
                   is_complex=True)

    def __init__(self, stages: Sequence[PipelineStage] | None = None,
                 **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.set(stages=list(stages))

    def fit(self, table: DataTable) -> "PipelineModel":
        stages = list(self.stages or [])
        bad = [f"stage {i} ({type(s).__name__}) is neither a Transformer "
               "nor an Estimator" for i, s in enumerate(stages)
               if not isinstance(s, (Transformer, Estimator))]
        if bad:
            raise TypeError("Pipeline has invalid stages:\n  "
                            + "\n  ".join(bad))
        last_est = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        fitted: list[Transformer] = []
        current = table
        for i, stage in enumerate(stages):
            model = (stage.fit(current) if isinstance(stage, Estimator)
                     else stage)
            # transform only while a later estimator still needs the table
            if i < last_est:
                current = model.transform(current)
            fitted.append(model)
        return PipelineModel(stages=fitted)


class PipelineModel(Transformer):
    """A fitted :class:`Pipeline`: applies each transformer in order
    through the planner. The planner's segment cache lives on this
    instance, so repeated calls place the weights once."""

    stages = Param(default=None, doc="ordered list of fitted transformers",
                   is_complex=True)

    def __init__(self, stages: Sequence[Transformer] | None = None,
                 **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.set(stages=list(stages))

    def __getstate__(self):
        # cached segments (closures, device tensors, a lock) don't pickle;
        # the first transform after a load rebuilds them
        d = self.__dict__.copy()
        d.pop("_plan_cache", None)
        d.pop("_plan_lock", None)
        return d

    def transform(self, table: DataTable) -> DataTable:
        from mmlspark_tpu_torch.core import plan
        return plan.execute_stages(list(self.stages or []), table,
                                   cache_host=self)
