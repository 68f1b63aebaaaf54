"""Serving configuration — the bucket ladder and admission bounds (the port
of ``ServeConfig`` in ``mmlspark_tpu/serve/config.py``)."""

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
