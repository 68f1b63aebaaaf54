"""ModelServer — load, warm and serve fitted models (the port of
``mmlspark_tpu/serve/server.py``: ``ModelServer`` and ``Client``).

A served model is a :class:`~mmlspark_tpu_torch.models.torch_model.TorchModel`
(or any fitted table→table transformer) or a raw
:class:`~mmlspark_tpu_torch.models.bundle.ModelBundle`, which is wrapped in
a ``TorchModel`` reading column ``"input"`` and writing ``"scores"``. Every
load warms the whole bucket ladder through the same dispatch path requests
take, before the first request is routed to the model.

A generator (:meth:`ModelServer.add_generator`) is a causal
``TransformerTagger`` served token by token through a
:class:`~mmlspark_tpu_torch.serve.generate.GenerateBatcher`. Batch models
and generators share one namespace: one name, one servable. The JAX
server's SLO tracker and journal are not part of this port yet.
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
from mmlspark_tpu_torch.serve.config import GenerateConfig, ServeConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, ModelLoadError, ModelNotFound, ServerClosed,
)
from mmlspark_tpu_torch.serve.generate import GenerateBatcher, TokenStream
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
        self._generators: dict[str, GenerateBatcher] = {}
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
            reject = None
            if self._closed:
                reject = ServerClosed("server is closed")
            elif name in self._generators:
                reject = ModelLoadError(name, message=(
                    f"{name!r} already serves a generator — one name, one "
                    "servable"))
            old = None if reject else self._models.get(name)
            if reject is None:
                self._models[name] = batcher
        if reject is not None:
            batcher.close(drain=False)
            raise reject
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

    # -- autoregressive token serving (serve/generate.py) --

    def add_generator(self, name: str, model: Any, state_dict: Any = None,
                      config: GenerateConfig | None = None,
                      decode_attention_fn: Any = None,
                      device: Any = None) -> None:
        """Register a token-serving engine under ``name``: a causal
        :class:`~mmlspark_tpu_torch.models.sequence.TransformerTagger`
        (with ``state_dict`` loaded into it, when given) served through
        continuous batching with the KV cache as plan-managed device
        state. Runs on ``device`` (None = cuda, which raises without a
        card; ``"cpu"`` when asked). Re-registering a generator's name
        swaps it in: the old engine drains first."""
        cfg = config or GenerateConfig()
        engine = GenerateBatcher(name, model, state_dict, config=cfg,
                                 decode_attention_fn=decode_attention_fn,
                                 device=device)
        reject = None
        old = None
        with self._lock:
            if self._closed:
                reject = ServerClosed("server is closed")
            elif name in self._models:
                reject = ModelLoadError(name, message=(
                    f"{name!r} already serves a batch model — one name, "
                    "one servable"))
            else:
                old = self._generators.get(name)
                self._generators[name] = engine
        if reject is not None:
            engine.close(drain=False)
            raise reject
        if old is not None:
            old.close(drain=True)
        _log.info("serve[%s]: generator loaded (slots=%d, "
                  "prefill_buckets=%s, t_max=%d)", name, cfg.slots,
                  cfg.prefill_buckets, cfg.t_max)

    def _generator(self, name: str) -> GenerateBatcher:
        with self._lock:
            engine = self._generators.get(name)
            if engine is None:
                raise ModelNotFound(name, list(self._generators))
            return engine

    def generate(self, name: str, prompt: Any,
                 max_new_tokens: int | None = None) -> TokenStream:
        """Admit a generation request on generator ``name``; returns the
        :class:`~mmlspark_tpu_torch.serve.generate.TokenStream`."""
        return self._generator(name).submit(prompt,
                                            max_new_tokens=max_new_tokens)

    def generate_oneshot(self, name: str, prompt: Any,
                         max_new_tokens: int | None = None) -> list[int]:
        """Whole-sequence reference decode of one prompt through generator
        ``name``'s own steps on fresh buffers (engine state untouched): the
        bit-identity anchor of every continuously batched stream."""
        return self._generator(name).oneshot(prompt,
                                             max_new_tokens=max_new_tokens)

    def generators(self) -> list[str]:
        with self._lock:
            return sorted(self._generators)

    # -- introspection --

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def stats(self, name: str) -> ServerStats:
        return self._batcher(name).stats

    def snapshot(self) -> dict:
        """All models' and generators' stats in one JSON-safe dict."""
        with self._lock:
            batchers = {**self._models, **self._generators}
        out = {}
        for name, b in batchers.items():
            snap = b.stats.snapshot()
            snap["queued"] = b.queued
            out[name] = snap
        return out

    # -- lifecycle --

    def close(self, drain: bool = True) -> None:
        """Shut down every model's batcher and every generator;
        ``drain=True`` answers all admitted requests and streams first. No
        thread survives."""
        with self._lock:
            self._closed = True
            batchers = [*self._models.values(), *self._generators.values()]
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

    def generate(self, model: str, prompt, max_new_tokens: int | None = None,
                 stream: bool = False, timeout: float | None = None):
        """Token generation on a registered generator. ``stream=True``
        returns the :class:`~mmlspark_tpu_torch.serve.generate.TokenStream`
        (iterate for tokens as they decode); the default blocks for the
        full token list."""
        handle = self.server.generate(model, list(prompt), max_new_tokens)
        return handle if stream else handle.result(timeout)
