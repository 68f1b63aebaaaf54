"""Serving configuration — the bucket ladder and admission bounds (the port
of ``ServeConfig`` and ``GenerateConfig`` in
``mmlspark_tpu/serve/config.py``)."""

from __future__ import annotations

import dataclasses

from mmlspark_tpu_torch.serve.errors import BadRequest, ModelLoadError

DEFAULT_BUCKETS = (1, 8, 32, 128)


def validate_ladder(buckets) -> tuple[int, ...]:
    """Normalize + validate one bucket ladder: every rung a positive int,
    strictly ascending. Raises ``ValueError`` naming the offending rung."""
    try:
        out = tuple(int(b) for b in buckets)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bucket ladder {buckets!r}: not ints ({e})")
    if not out:
        raise ValueError("bucket ladder is empty")
    for i, b in enumerate(out):
        if b < 1:
            raise ValueError(
                f"bucket ladder {out!r}: rung {b} at index {i} is not "
                f"a positive row count")
    for i in range(1, len(out)):
        if out[i] == out[i - 1]:
            raise ValueError(
                f"bucket ladder {out!r}: duplicate rung {out[i]}")
        if out[i] < out[i - 1]:
            raise ValueError(
                f"bucket ladder {out!r}: rung {out[i]} after "
                f"{out[i - 1]} — rungs must be strictly ascending")
    return out


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one :class:`~mmlspark_tpu_torch.serve.server.ModelServer`.

    ``buckets`` is the fixed ladder request batches are padded onto: the
    batcher packs whole requests up to the largest bucket and pads to the
    smallest bucket that fits, so the device only ever sees
    ``len(buckets)`` batch shapes, each warmed at load.
    """

    buckets: tuple = DEFAULT_BUCKETS
    max_queue: int = 128        # queued requests per model; admission bound
    deadline_ms: float | None = None  # default per-request deadline
    max_inflight: int = 2       # dispatched-but-undrained batches (device
    #                             memory and latency bound of the window)
    warmup: bool = True         # run every bucket once at load time
    stats_window: int = 4096    # per-model latency reservoir bound
    drain_timeout_s: float = 30.0  # close(drain=True) join bound

    def __post_init__(self):
        # a misordered or duplicated ladder is a deploy bug: refuse it
        # with the typed load error rather than repair it
        try:
            buckets = validate_ladder(self.buckets)
        except ValueError as e:
            raise ModelLoadError("<config>", message=str(e))
        object.__setattr__(self, "buckets", buckets)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1: {self.max_queue}")
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1: {self.max_inflight}")

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int, model: str = "?") -> int:
        """Smallest bucket admitting ``rows`` rows."""
        for b in self.buckets:
            if rows <= b:
                return b
        raise BadRequest(
            f"model {model!r}: request of {rows} rows exceeds the largest "
            f"bucket {self.max_bucket} (requests are never split)")


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Knobs of one autoregressive token-serving engine
    (:class:`~mmlspark_tpu_torch.serve.generate.GenerateBatcher`).

    Prompt *lengths* quantize onto ``prefill_buckets`` (a validated
    ladder) while the prefill *row* dimension is always padded to
    ``prefill_rows``, so prefill sees at most ``len(prefill_buckets)``
    input shapes; decode is ONE fixed shape ``[slots]`` forever — requests
    join and leave per token step through the active-slot mask. Total
    shapes ≤ ``len(prefill_buckets) + 1``.
    """

    slots: int = 8              # decode batch width = KV-cache slot count
    t_max: int = 128            # cache horizon [.., T_max, ..]: prompt +
    #                             generated tokens per request must fit
    prefill_buckets: tuple = (8, 32)  # prompt-length ladder (tokens)
    prefill_rows: int = 4       # fixed row dim of the prefill step: up to
    #                             this many waiting prompts pack into one
    #                             prefill (pad rows are never scattered)
    max_new_tokens: int = 16    # default generation budget per request
    max_queue: int = 128        # waiting-for-a-slot bound; admission
    #                             backpressure past it (Overloaded)
    retry_after_s: float = 1.0  # backpressure hint stamped on Overloaded/
    #                             ServerClosed
    eos_token: int | None = None  # stop token (None = run to budget)
    stats_window: int = 4096
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        try:
            buckets = validate_ladder(self.prefill_buckets)
        except ValueError as e:
            raise ModelLoadError("<generate-config>", message=str(e))
        object.__setattr__(self, "prefill_buckets", buckets)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1: {self.slots}")
        if self.prefill_rows < 1:
            raise ValueError(
                f"prefill_rows must be >= 1: {self.prefill_rows}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1: {self.max_queue}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1: {self.max_new_tokens}")
        if self.t_max < buckets[-1] + 1:
            raise ValueError(
                f"t_max={self.t_max} cannot hold the largest prefill "
                f"bucket {buckets[-1]} plus one generated token")

    def prefill_bucket_for(self, tokens: int, model: str = "?") -> int:
        """Smallest prompt-length bucket admitting ``tokens`` tokens."""
        for b in self.prefill_buckets:
            if tokens <= b:
                return b
        raise BadRequest(
            f"model {model!r}: prompt of {tokens} tokens exceeds the "
            f"largest prefill bucket {self.prefill_buckets[-1]}")
