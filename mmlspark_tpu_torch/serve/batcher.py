"""DynamicBatcher — per-model coalescing dispatch loop (the port of
``mmlspark_tpu/serve/batcher.py`` on one device).

Coalesced requests are packed into padded batches drawn from a fixed
bucket ladder (``ServeConfig.buckets``), so the device sees at most
``len(buckets)`` batch shapes, each warmed at load:

* **admission** is a bounded FIFO — a full queue rejects with the typed
  :class:`~mmlspark_tpu_torch.serve.errors.Overloaded`, and requests whose
  deadline expires while queued are cancelled *before dispatch*;
* **packing** takes whole requests in FIFO order up to the largest bucket
  and pads to the smallest bucket that fits by repeating the last row (a
  request is never split, so a timeout can never observe a partial
  result);
* **dispatch** runs on one lane worker: the scheduler thread packs batch
  *i+1* while the card computes batch *i*; the lane drives
  ``core.plan.transform_async`` (one pinned upload, one forward, one
  async fetch behind a CUDA event) and keeps at most ``max_inflight``
  dispatched-but-undrained batches;
* **shutdown** (``close(drain=True)``) stops admission, answers every
  admitted request, then joins the scheduler and the lane worker.

Threads are named ``TorchServeBatcher[...]``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.serve.config import ServeConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, DeadlineExceeded, Overloaded, ServerClosed,
)
from mmlspark_tpu_torch.serve.stats import ServerStats

_log = get_logger(__name__)

THREAD_PREFIX = "TorchServeBatcher"

# request states — transitions are guarded by the request's own lock
_QUEUED, _DISPATCHED, _DONE, _TIMED_OUT = range(4)


def _cell_sig(cell: Any) -> tuple:
    if isinstance(cell, np.ndarray):
        return ("array", cell.shape, str(cell.dtype))
    if isinstance(cell, (list, tuple)):
        return ("seq", len(cell))
    return ("cell", type(cell).__name__)


def _compat_key(table: DataTable) -> tuple:
    """Batch-compatibility fingerprint: column names plus the per-cell
    layout of every row. Requests only coalesce when keys match, so a
    wrong-shape request is dispatched alone and fails alone; a request
    whose own rows are ragged is keyed by its whole cell-by-cell layout."""
    parts = []
    for name in sorted(table.columns):
        col = table[name]
        if col.dtype != object:
            parts.append((name, ("np", str(col.dtype))))
            continue
        sig = _cell_sig(col[0]) if len(col) else ("empty",)
        if any(_cell_sig(cell) != sig for cell in col[1:]):
            sig = ("nonuniform", tuple(_cell_sig(c) for c in col))
        parts.append((name, sig))
    return tuple(parts)


class ServeRequest:
    """Handle for one admitted request; wait with :meth:`result`.

    Resolution is atomic per request: a request gets either its complete
    output table or exactly one typed error, and a result arriving after
    the caller gave up is discarded."""

    __slots__ = ("model", "table", "n_rows", "deadline_ms", "_deadline",
                 "_submitted", "_dispatched_at", "_state", "_lock",
                 "_event", "_result", "_error", "_stats", "_compat")

    def __init__(self, model: str, table: DataTable,
                 deadline_ms: float | None, stats: ServerStats):
        self.model = model
        self.table = table
        self.n_rows = len(table)
        self._compat = _compat_key(table)
        self.deadline_ms = deadline_ms
        now = time.monotonic()
        self._submitted = now
        self._deadline = (None if deadline_ms is None
                          else now + deadline_ms / 1e3)
        self._dispatched_at: float | None = None
        self._state = _QUEUED
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._result: DataTable | None = None
        self._error: BaseException | None = None
        self._stats = stats

    # -- batcher side --

    def _mark_dispatched(self, now: float) -> None:
        with self._lock:
            if self._state == _QUEUED:
                self._state = _DISPATCHED
                self._dispatched_at = now

    def _resolve(self, table: DataTable) -> bool:
        """Deliver the result; False when the caller already gave up."""
        with self._lock:
            if self._state == _TIMED_OUT:
                return False
            self._state = _DONE
            self._result = table
        self._event.set()
        return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._state == _TIMED_OUT:
                return False
            self._state = _DONE
            self._error = error
        self._event.set()
        return True

    # -- caller side --

    def result(self, timeout: float | None = None) -> DataTable:
        """Block until resolution; raises the request's typed error.

        The effective wait is the sooner of ``timeout`` and the request's
        own deadline. On expiry the request is atomically and terminally
        marked timed out: :class:`DeadlineExceeded` (or ``TimeoutError``
        when only ``timeout`` ran out) is raised, now and on every repeat
        call, and any later resolution is discarded."""
        with self._lock:
            if self._state == _TIMED_OUT:
                raise self._error
        waits = [t for t in (timeout, None if self._deadline is None
                             else self._deadline - time.monotonic())
                 if t is not None]
        ok = self._event.wait(min(waits) if waits else None)
        with self._lock:
            if self._state == _DONE:
                if self._error is not None:
                    raise self._error
                return self._result
            self._state = _TIMED_OUT
            if not ok and timeout is not None and (
                    self._deadline is None
                    or time.monotonic() < self._deadline):
                self._error = TimeoutError(
                    f"model {self.model!r}: no result within {timeout}s "
                    "(request deadline not yet reached)")
            else:
                self._error = DeadlineExceeded(
                    self.model, self.deadline_ms or 0.0,
                    "queued" if self._dispatched_at is None
                    else "in-flight")
            err = self._error
        self._stats.record_timeout()
        raise err


class _Lane:
    """The dispatch lane: one worker thread that issues packed batches
    through the device plan and drains its in-flight window — at most
    ``max_inflight`` dispatched-but-undrained batches. On shutdown the
    worker finishes everything already assigned to it."""

    def __init__(self, batcher: "DynamicBatcher"):
        self.batcher = batcher
        self._cv = threading.Condition()
        self._queue: deque = deque()   # (packed, batch, rows, bucket)
        self._window: deque = deque()  # (pending, batch, rows, bucket, t0)
        self._closing = False
        self._thread = threading.Thread(
            target=self._run, name=f"{THREAD_PREFIX}[{batcher.name}]#0",
            daemon=True)
        self._thread.start()

    def assign(self, packed: DataTable, batch: list, rows: int,
               bucket: int) -> None:
        with self._cv:
            self._queue.append((packed, batch, rows, bucket))
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _release(self) -> None:
        """One batch fully resolved: free its slot and wake the
        scheduler."""
        cv = self.batcher._sched_cv
        with cv:
            self.batcher._inflight -= 1
            cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while (not self._queue and not self._window
                       and not self._closing):
                    self._cv.wait()
                item = self._queue.popleft() if self._queue else None
                closing = self._closing
            if item is None:
                if self._window:
                    self._drain_one()  # idle: finish outstanding batches
                    continue
                if closing:
                    return
                continue
            self._dispatch(*item)
            if len(self._window) >= self.batcher.config.max_inflight:
                self._drain_one()

    def _fail_batch(self, batch: list, error: BaseException) -> None:
        for r in batch:
            if r._fail(error):
                self.batcher.stats.record_failed()
        self._release()

    def _dispatch(self, packed: DataTable, batch: list, rows: int,
                  bucket: int) -> None:
        now = time.monotonic()
        if all(r._deadline is not None and now >= r._deadline
               for r in batch):
            # the whole batch expired while waiting for the lane: cancel
            # before dispatch instead of spending device time on it
            for r in batch:
                if r._fail(DeadlineExceeded(self.batcher.name,
                                            r.deadline_ms or 0.0,
                                            "queued")):
                    self.batcher.stats.record_expired()
            self._release()
            return
        for r in batch:
            r._mark_dispatched(now)
        try:
            pending = plan.transform_async(self.batcher.stages, packed)
        except Exception as e:  # noqa: BLE001 — relayed per request
            self._fail_batch(batch, e)
            return
        self._window.append((pending, batch, rows, bucket, now))

    def _drain_one(self) -> None:
        pending, batch, rows, bucket, t0 = self._window.popleft()
        try:
            out = pending.result()
        except Exception as e:  # noqa: BLE001 — relayed per request
            _log.warning("%s: batch of %d failed: %s", self.batcher.name,
                         rows, e)
            self._fail_batch(batch, e)
            return
        done = time.monotonic()
        self.batcher.stats.record_batch(bucket, rows, (done - t0) * 1e3,
                                        pending.shapes)
        if len(out) != bucket:
            # a row-count-changing stage breaks the per-request split
            self._fail_batch(batch, BadRequest(
                f"model {self.batcher.name!r}: transform changed the row "
                f"count ({bucket} in, {len(out)} out) — row-preserving "
                "models only"))
            return
        offset = 0
        for r in batch:
            idx = np.arange(offset, offset + r.n_rows)
            offset += r.n_rows
            if r._resolve(out.take(idx)):
                self.batcher.stats.record_done(
                    (done - r._submitted) * 1e3,
                    ((r._dispatched_at or done) - r._submitted) * 1e3)
        self._release()


class DynamicBatcher:
    """Bounded request queue + coalescing dispatch loop for ONE model."""

    def __init__(self, name: str, stages: list, config: ServeConfig,
                 stats: ServerStats | None = None):
        self.name = name
        self.stages = list(stages)
        self.config = config
        self.stats = stats or ServerStats(config.stats_window, model=name)
        self._cv = threading.Condition()
        self._queue: deque[ServeRequest] = deque()
        self._closed = False     # admission stopped (drain in progress)
        self._abort = False      # fail queued work instead of draining
        # batches assigned to the lane and not yet resolved
        self._sched_cv = threading.Condition()
        self._inflight = 0
        self._lane = _Lane(self)
        self._thread = threading.Thread(
            target=self._run, name=f"{THREAD_PREFIX}[{name}]", daemon=True)
        self._thread.start()

    # -- admission --

    def submit(self, table: DataTable,
               deadline_ms: float | None = None) -> ServeRequest:
        """Admit one request (whole table = one atomic unit of work)."""
        n = len(table)
        if n == 0:
            raise BadRequest(f"model {self.name!r}: empty request")
        if n > self.config.max_bucket:
            self.config.bucket_for(n, self.name)  # raises BadRequest
        req = ServeRequest(self.name, table, deadline_ms, self.stats)
        with self._cv:
            if self._closed:
                raise ServerClosed(f"model {self.name!r} is shutting down")
            if len(self._queue) >= self.config.max_queue:
                self.stats.record_rejected()
                raise Overloaded(self.name, len(self._queue),
                                 self.config.max_queue)
            self._queue.append(req)
            self.stats.record_admitted()
            self._cv.notify()
        return req

    @property
    def queued(self) -> int:
        with self._cv:
            return len(self._queue)

    # -- the dispatch loop --

    def _collect(self, now: float) -> tuple[list, list, int]:
        """Pop expired requests plus the next packable FIFO run (whole,
        layout-compatible requests, total rows ≤ the largest bucket)."""
        batch: list[ServeRequest] = []
        expired: list[ServeRequest] = []
        rows = 0
        with self._cv:
            while self._queue:
                r = self._queue[0]
                if r._deadline is not None and now >= r._deadline:
                    self._queue.popleft()
                    expired.append(r)
                    continue
                if batch and (rows + r.n_rows > self.config.max_bucket
                              or r._compat != batch[0]._compat):
                    break
                self._queue.popleft()
                batch.append(r)
                rows += r.n_rows
        return batch, expired, rows

    def _pack(self, batch: list, rows: int) -> tuple[DataTable, int]:
        """Concatenate the requests' rows in one multi-way pass and pad to
        the bucket size by repeating the last row (trimmed on emit)."""
        bucket = self.config.bucket_for(rows, self.name)
        first = batch[0].table
        if len(batch) == 1 and bucket == rows:
            return first, bucket
        tables = [r.table for r in batch]
        if bucket > rows:
            tables.append(tables[-1].take(
                np.full(bucket - rows, len(tables[-1]) - 1)))
        return tables[0].concat(*tables[1:]), bucket

    def _acquire_slot(self) -> bool:
        """Wait for a free slot of the ``max_inflight`` window; False when
        aborted."""
        with self._sched_cv:
            while not self._abort:
                if self._inflight < self.config.max_inflight:
                    self._inflight += 1
                    return True
                self._sched_cv.wait(timeout=0.1)
        return False

    def _run(self) -> None:
        while not self._abort:
            batch, expired, rows = self._collect(time.monotonic())
            for r in expired:
                if r._fail(DeadlineExceeded(self.name,
                                            r.deadline_ms or 0.0,
                                            "queued")):
                    self.stats.record_expired()
            if batch:
                try:
                    # pack on this thread: it overlaps the lane's device
                    # work on the previous batch
                    packed, bucket = self._pack(batch, rows)
                    if not self._acquire_slot():
                        raise ServerClosed(f"model {self.name!r} closed")
                    self._lane.assign(packed, batch, rows, bucket)
                except Exception as e:  # noqa: BLE001 — per request
                    for r in batch:
                        if r._fail(e):
                            self.stats.record_failed()
                continue
            with self._cv:
                if self._queue:
                    continue  # raced with a submit
                if self._closed or self._abort:
                    break
                # every path that adds work or shuts down notifies here
                self._cv.wait()
        # batches already assigned complete even on abort: the lane
        # finishes its queue and window before it exits
        self._lane.close()
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
        for r in leftovers:
            r._fail(ServerClosed(f"model {self.name!r} closed"))

    # -- warmup --

    def warm(self, padded: DataTable) -> None:
        """Run one padded batch through the same dispatch path requests
        take, synchronously, recording nothing in the request stats."""
        plan.transform_async(self.stages, padded).result()

    # -- lifecycle --

    def close(self, drain: bool = True) -> None:
        """Stop admission; ``drain=True`` answers every admitted request
        before the workers exit, ``drain=False`` fails queued requests
        with :class:`ServerClosed`. Idempotent; joins both threads."""
        with self._cv:
            self._closed = True
            if not drain:
                self._abort = True
            self._cv.notify_all()
        with self._sched_cv:
            self._sched_cv.notify_all()  # unblock an _acquire_slot wait
        deadline = time.monotonic() + self.config.drain_timeout_s
        self._thread.join(timeout=self.config.drain_timeout_s)
        self._lane.close()
        stuck = self._thread.is_alive() or not self._lane.join(
            max(deadline - time.monotonic(), 0.1))
        if stuck:
            _log.warning("%s[%s] did not stop within %.1fs", THREAD_PREFIX,
                         self.name, self.config.drain_timeout_s)
