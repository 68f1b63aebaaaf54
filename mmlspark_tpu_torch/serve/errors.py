"""Typed serving errors — the admission/deadline contract surface (the
port of ``mmlspark_tpu/serve/errors.py``).

Every rejection a client can see is a distinct type, so callers dispatch
on type, never on message text.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base of every serving-layer error.

    ``retry_after_s`` is the server's backpressure hint: ``None`` means it
    offered none. The backpressure errors (:class:`Overloaded`,
    :class:`ServerClosed`) carry it from the rejecting engine's config."""

    retry_after_s: float | None = None


class Overloaded(ServeError):
    """Admission rejected: the model's request queue is full.
    Backpressure, not failure — retry with backoff or shed load."""

    def __init__(self, model: str, queued: int, max_queue: int,
                 retry_after_s: float | None = None):
        super().__init__(
            f"model {model!r} overloaded: {queued} requests queued "
            f"(max_queue={max_queue})")
        self.model = model
        self.queued = queued
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline expired before a result was delivered —
    cancelled in the queue before dispatch, or given up on by the caller
    mid-flight. Either way the caller gets only this error, never a
    partial result."""

    def __init__(self, model: str, deadline_ms: float, where: str):
        super().__init__(
            f"model {model!r}: deadline of {deadline_ms:.0f} ms exceeded "
            f"({where})")
        self.model = model
        self.deadline_ms = deadline_ms
        self.where = where  # "queued" | "in-flight"


class BadRequest(ServeError):
    """Malformed request: empty, larger than the biggest bucket, or
    column-incompatible with the served model."""


class ModelNotFound(ServeError):
    """No model registered under the requested name."""

    def __init__(self, name: str, available: list[str]):
        super().__init__(f"no model {name!r}; serving: {sorted(available)}")
        self.name = name
        self.available = list(available)


class ServerClosed(ServeError):
    """Submission after shutdown began (new work is rejected during
    drain)."""

    def __init__(self, message: str = "server is closed",
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ModelLoadError(ServeError):
    """The model or its serving config was rejected at load time, before
    any request was routed to it."""

    def __init__(self, name: str, message: str):
        super().__init__(message)
        self.name = name
