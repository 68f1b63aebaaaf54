"""The device plan: upload → forward → async fetch, with a bounded window.

The port of the single-device-stage path of ``mmlspark_tpu/core/plan.py``
(``minibatches``, ``_windowed_dispatch``, ``PendingTable``,
``transform_async``). One pass over a host batch:

* the batch is cut into fixed-size minibatches, the tail padded with
  zeros, so every forward sees one of a few shapes;
* each minibatch is copied into pinned host memory and uploaded with
  ``non_blocking=True``, the stage's forward is enqueued on the current
  stream, and its output is copied back into pinned host memory, also
  ``non_blocking``, with a CUDA event recorded behind the copy — so the
  call returns as soon as the work is *enqueued*, and the caller (the
  serve batcher) packs the next batch while the card computes this one;
* at most ``MAX_INFLIGHT`` minibatch outputs are outstanding: the oldest
  is waited on (its event) before another is enqueued.

:class:`PendingTable` is the handle: ``result()`` waits on the events,
trims the padding and writes the output column. On a CPU target the same
code runs synchronously (no pinning, no events).

Fusing runs of several device stages into one program, as the JAX plan
does, is not part of this slice: only the trailing stage of a list runs on
the device, every stage before it runs on the host.

Stateful segments (the port of the JAX plan's ``SegmentState``,
``allocate_segment_state`` and ``StatefulSegment``) hold device state
across dispatches: the token-generation engine's KV cache. The buffers
are allocated zeroed once, owned by one :class:`SegmentState`, and every
dispatch mutates them in place under its lock (the JAX plan donates them
to each jitted step instead). A :class:`StatefulSegment` records the
distinct input shapes it has run: eager PyTorch compiles nothing, so that
set stands in for the JAX engine's compiled-program budget.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterator

import numpy as np
import torch

from mmlspark_tpu_torch.core.stage import DeviceStage
from mmlspark_tpu_torch.data.table import DataTable

# outstanding minibatch outputs per dispatch (the JAX stage's
# max_inflight default): bounds device memory on very large tables
MAX_INFLIGHT = 8


def minibatches(batch: np.ndarray, size: int
                ) -> Iterator[tuple[np.ndarray, int]]:
    """Yield fixed-shape minibatches; the tail is zero-padded to ``size``."""
    n = len(batch)
    for start in range(0, n, size):
        chunk = batch[start:start + size]
        valid = len(chunk)
        if valid < size:
            pad = np.zeros((size - valid,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        yield chunk, valid


def _upload(chunk: np.ndarray, device: torch.device) -> torch.Tensor:
    """ONE host→device transfer of one minibatch, from pinned memory."""
    host = torch.from_numpy(np.ascontiguousarray(chunk))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _issue_fetch(out: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """ONE async device→host fetch of one minibatch's output into pinned
    memory; returns the host tensor and the event that marks it filled."""
    if not out.is_cuda:
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _windowed_dispatch(forward: Callable[[torch.Tensor], torch.Tensor],
                       batch: np.ndarray, size: int, device: torch.device,
                       max_inflight: int
                       ) -> tuple[list, list, Callable[[], None]]:
    """Enqueue every minibatch of ``batch``, waiting on the oldest output
    whenever ``max_inflight`` are outstanding. Returns ``(pieces, shapes,
    drain_rest)``: ``pieces`` receives one trimmed host array per drained
    minibatch in order, ``shapes`` the uploaded shapes, and
    ``drain_rest()`` waits for the rest — callers choose when to pay it."""
    window: deque = deque()
    pieces: list[np.ndarray] = []
    shapes: list[tuple] = []
    inflight = max(1, int(max_inflight))

    def drain_one() -> None:
        host, event, valid = window.popleft()
        if event is not None:
            event.synchronize()
        # a copy, so results handed to callers never pin host memory
        pieces.append(host.numpy()[:valid].copy())

    for chunk, valid in minibatches(batch, size):
        shapes.append(tuple(chunk.shape))
        out = forward(_upload(chunk, device))
        window.append((*_issue_fetch(out), valid))
        while len(window) > inflight:
            drain_one()

    def drain_rest() -> None:
        while window:
            drain_one()

    return pieces, shapes, drain_rest


class PendingTable:
    """Handle for an asynchronously dispatched transform.

    ``result()`` waits for the device→host copies, writes the output
    column and returns the finished :class:`DataTable`; it is idempotent.
    A PendingTable built from a finished table returns it at once.
    ``shapes`` holds the batch shapes uploaded to the device (empty for a
    host-only transform). Single consumer: the serve batcher's in-flight
    window owns each handle."""

    __slots__ = ("_table", "_finish", "shapes")

    def __init__(self, table: DataTable | None = None,
                 finish: Callable[[], DataTable] | None = None,
                 shapes: tuple = ()):
        self._table = table
        self._finish = finish
        self.shapes = tuple(shapes)

    def result(self) -> DataTable:
        if self._finish is not None:
            self._table = self._finish()
            self._finish = None
        return self._table


def dispatch(stage: DeviceStage, table: DataTable) -> PendingTable:
    """Enqueue ``stage``'s forward over ``table`` and return at once.

    A batch at or below the stage's ``minibatch_size`` — the serving case,
    since bucket ladders are sized to fit — is ONE minibatch: one upload,
    one forward, one fetch. A larger one is cut at that bound, the tail
    padded, with at most ``MAX_INFLIGHT`` outputs outstanding."""
    batch = stage.device_entry(table)
    size = min(int(stage.minibatch_size), len(batch))
    pieces, shapes, drain_rest = _windowed_dispatch(
        stage.device_forward, batch, size, stage.target_device(),
        MAX_INFLIGHT)

    def finish() -> DataTable:
        drain_rest()
        out = np.concatenate(pieces) if len(pieces) > 1 else pieces[0]
        return stage.device_emit(table, out)

    return PendingTable(finish=finish, shapes=tuple(shapes))


def transform_async(stages: list, table: DataTable) -> PendingTable:
    """Run a fitted-transformer list over one packed batch: every stage but
    the last on the host, then the last one — when it is a
    :class:`DeviceStage` and the table has rows — dispatched
    asynchronously (the serving execution engine)."""
    stages = list(stages)
    for stage in stages[:-1]:
        table = stage.transform(table)
    last = stages[-1]
    if isinstance(last, DeviceStage) and len(table):
        return dispatch(last, table)
    return PendingTable(table=last.transform(table))


# ---- stateful segments (device state across dispatches) ----

class SegmentState:
    """Device buffers owned by a stateful segment (for the serve plane,
    the slot-major KV-cache pair ``[slots, layers, heads, T_max, d]``).
    Every mutation runs under :meth:`locked`, so a dispatch and a reader
    never interleave."""

    __slots__ = ("name", "buffers", "_lock")

    def __init__(self, name: str, buffers: dict[str, torch.Tensor]):
        self.name = name
        self.buffers = buffers
        self._lock = threading.Lock()

    def locked(self, fn: Callable[[dict], Any]) -> Any:
        """Run ``fn(buffers)`` under the lock; ``fn`` may update the
        buffers in place. Returns what ``fn`` returns."""
        with self._lock:
            return fn(self.buffers)


def allocate_segment_state(name: str, shapes: dict, device: Any,
                           dtype: torch.dtype = torch.float32
                           ) -> SegmentState:
    """Zeroed buffers on ``device``, one per ``name → shape`` entry. Zero
    is the right start for a KV cache: the active-slot mask keeps unwritten
    positions out of every attention denominator."""
    bufs = {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in shapes.items()}
    return SegmentState(name, bufs)


class StatefulSegment:
    """A step function over :class:`SegmentState`.

    ``step_fn(buffers, *args) -> out`` updates the buffers in place and
    returns its outputs (device tensors: the caller owns the fetch).
    :meth:`dispatch` runs it on the owned state under the state's lock;
    :meth:`run` on buffers the caller passes (fresh ones, for a reference
    run). Both record the shapes of ``args``: :attr:`shapes` is the set of
    distinct input shapes the step has seen."""

    __slots__ = ("name", "step_fn", "state", "shapes", "_shape_lock")

    def __init__(self, name: str, step_fn: Callable, state: SegmentState):
        self.name = name
        self.step_fn = step_fn
        self.state = state
        self.shapes: set = set()
        self._shape_lock = threading.Lock()

    def run(self, buffers: dict, *args) -> Any:
        with self._shape_lock:
            self.shapes.add(tuple(tuple(np.shape(a)) for a in args))
        with torch.no_grad():
            return self.step_fn(buffers, *args)

    def dispatch(self, *args) -> Any:
        """One step on the owned state, serialised under its lock."""
        return self.state.locked(lambda bufs: self.run(bufs, *args))
