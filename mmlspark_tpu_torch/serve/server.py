"""ModelServer — load, warm and serve fitted models (the port of
``mmlspark_tpu/serve/server.py``: ``ModelServer`` and ``Client``).

A served model is a :class:`~mmlspark_tpu_torch.models.torch_model.TorchModel`
(or any fitted table→table transformer) or a raw
:class:`~mmlspark_tpu_torch.models.bundle.ModelBundle`, which is wrapped in
a ``TorchModel`` reading column ``"input"`` and writing ``"scores"``. Every
load warms the whole bucket ladder through the same dispatch path requests
take, before the first request is routed to the model.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.serve.batcher import DynamicBatcher, ServeRequest
from mmlspark_tpu_torch.serve.config import ServeConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, ModelNotFound, ServerClosed,
)
from mmlspark_tpu_torch.serve.stats import ServerStats

_log = get_logger(__name__)


def _as_stages(model: Any, device: Any) -> list:
    """The stage list of a servable object; a bundle is wrapped in a
    ``TorchModel`` on ``device`` (None = cuda)."""
    if isinstance(model, ModelBundle):
        model = TorchModel(model=model, input_col="input",
                           output_col="scores", device=device)
    if not hasattr(model, "transform"):
        raise BadRequest(
            f"not a servable model: {type(model).__name__} (needs "
            ".transform or a ModelBundle)")
    return [model]


def _derived_example(stages: list) -> DataTable | None:
    """One all-zeros row realizing a leading ``TorchModel``'s input
    contract (the flat float32 vector ``coerce_input_matrix`` accepts);
    None for any other model."""
    first = stages[0]
    if not isinstance(first, TorchModel) or first.model is None:
        return None
    size = int(np.prod(tuple(first.model.input_spec)))
    return DataTable({first.input_col: [np.zeros(size, np.float32)]})


class ModelServer:
    """Serves one or more fitted models through per-model dynamic batchers.

    Thread-safe: :meth:`submit`/:meth:`predict` may be called from any
    number of client threads."""

    def __init__(self, config: ServeConfig | None = None):
        self.config = config or ServeConfig()
        self._models: dict[str, DynamicBatcher] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- loading --

    def add_model(self, name: str, model: Any,
                  example: DataTable | None = None,
                  device: Any = None) -> None:
        """Register ``model`` under ``name`` and warm every bucket of the
        ladder with ``example`` rows (its first row, repeated to each
        bucket size; rows synthesized from the bundle's ``input_spec``
        when ``example`` is None). ``device`` places a raw bundle's
        ``TorchModel`` (None = cuda). Re-registering a name swaps the
        model in: the old batcher drains after the flip."""
        stages = _as_stages(model, device)
        batcher = DynamicBatcher(name, stages, self.config,
                                 ServerStats(self.config.stats_window,
                                             model=name))
        try:
            if self.config.warmup:
                warm = example if example is not None \
                    else _derived_example(stages)
                if warm is not None and len(warm):
                    self._warm(batcher, warm)
                else:
                    _log.info("serve[%s]: no example rows — skipping "
                              "warmup", name)
        except BaseException:
            batcher.close(drain=False)
            raise
        with self._lock:
            closed = self._closed
            old = None if closed else self._models.get(name)
            if not closed:
                self._models[name] = batcher
        if closed:
            batcher.close(drain=False)
            raise ServerClosed("server is closed")
        if old is not None:
            old.close(drain=True)
        _log.info("serve[%s]: loaded (buckets=%s)", name,
                  self.config.buckets)

    def _warm(self, batcher: DynamicBatcher, example: DataTable) -> None:
        """Run one padded batch per rung through the dispatch path."""
        for bucket in batcher.config.buckets:
            batcher.warm(example.take(np.zeros(bucket, dtype=np.int64)))

    # -- request surface --

    def _batcher(self, name: str) -> DynamicBatcher:
        with self._lock:
            batcher = self._models.get(name)
            if batcher is None:
                raise ModelNotFound(name, list(self._models))
            return batcher

    def submit(self, name: str, table: DataTable,
               deadline_ms: float | None = None) -> ServeRequest:
        """Admit a request; returns the awaitable handle. ``deadline_ms``
        defaults to ``ServeConfig.deadline_ms``. A swap that closes the
        old batcher between lookup and admission re-routes to the new
        one."""
        if deadline_ms is None:
            deadline_ms = self.config.deadline_ms
        while True:
            batcher = self._batcher(name)
            try:
                return batcher.submit(table, deadline_ms)
            except ServerClosed:
                with self._lock:
                    if self._closed or self._models.get(name) is batcher:
                        raise

    def predict(self, name: str, table: DataTable,
                deadline_ms: float | None = None,
                timeout: float | None = None) -> DataTable:
        """Blocking submit + wait."""
        return self.submit(name, table, deadline_ms).result(timeout)

    # -- introspection --

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def stats(self, name: str) -> ServerStats:
        return self._batcher(name).stats

    def snapshot(self) -> dict:
        """All models' stats in one JSON-safe dict."""
        with self._lock:
            batchers = dict(self._models)
        out = {}
        for name, b in batchers.items():
            snap = b.stats.snapshot()
            snap["queued"] = b.queued
            out[name] = snap
        return out

    # -- lifecycle --

    def close(self, drain: bool = True) -> None:
        """Shut down every model's batcher; ``drain=True`` answers all
        admitted requests first. No thread survives."""
        with self._lock:
            self._closed = True
            batchers = list(self._models.values())
        for b in batchers:
            b.close(drain=drain)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class Client:
    """In-process client: the deterministic test/bench surface."""

    def __init__(self, server: ModelServer):
        self.server = server

    def predict(self, model: str, rows: DataTable,
                deadline_ms: float | None = None,
                timeout: float | None = None) -> DataTable:
        return self.server.predict(model, rows, deadline_ms, timeout)

    def predict_async(self, model: str, rows: DataTable,
                      deadline_ms: float | None = None) -> ServeRequest:
        return self.server.submit(model, rows, deadline_ms)
