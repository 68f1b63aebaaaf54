"""Asynchronous prefetching train input: host batches assembled on a
background thread and uploaded to the device ahead of the step.

The port of ``mmlspark_tpu/train/input.py`` (``DeviceLoader``,
``input_stats``):

* **assembly** (the shuffled-batch gather) runs on ONE background thread
  pulling the host-batch iterator;
* the **commit** (:class:`HostToDevice`) copies each host batch into
  pinned memory and starts the host-to-device copy on a side CUDA stream,
  up to ``depth`` batches ahead of consumption, and records an event;
* the consumer takes a committed batch with :meth:`Transfer.ready`: the
  compute stream waits on the event (no host sync), and
  ``record_stream`` tells the caching allocator that the tensors, made on
  the side stream, are used on the compute stream;
* device memory held by in-flight batches is bounded by the depth; the
  producer's exception is raised where the consumer takes the batch;
  ``close()`` stops and joins the thread even when the consumer leaves
  mid-epoch.

``depth=0`` runs assembly and commit inline. Numerics are the same at
every depth: the same host batches commit in the same order; only WHEN
the copy starts moves.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger

_log = get_logger(__name__)

THREAD_PREFIX = "TorchDeviceLoader"

_ITEM, _ERROR, _DONE = "item", "error", "done"


@dataclasses.dataclass
class Transfer:
    """Tensors committed to the device; ``event`` marks the end of their
    copy on the side stream (None on the CPU)."""

    tensors: list
    event: Any = None

    def ready(self) -> list:
        """The tensors, safe to use on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


class HostToDevice:
    """The commit: numpy arrays → tensors on ``device``. For CUDA, each
    array is copied into pinned memory and uploaded on a side stream
    without blocking the host."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, arrays: Iterable[np.ndarray]) -> Transfer:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self.stream is None:
            return Transfer([torch.from_numpy(a) for a in arrays])
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = [torch.from_numpy(a).pin_memory().to(self.device,
                                                       non_blocking=True)
                   for a in arrays]
            event = torch.cuda.Event()
            event.record(self.stream)
        return Transfer(out, event)


class DeviceLoader:
    """Bounded-queue prefetching loader: iterate committed batches.

    ``source`` yields host items; ``commit`` maps an item to its committed
    form on the worker thread, up to ``depth`` items ahead (``0``: inline
    in ``__next__``). Accounting: ``committed``/``consumed``,
    ``max_ahead`` (batches committed beyond the one being consumed),
    ``wait_s`` (consumer time blocked on input; for ``depth=0`` the whole
    inline assembly and commit), ``assemble_s``/``commit_s``."""

    def __init__(self, source: Iterable | Iterator,
                 commit: Callable[[Any], Any], depth: int = 2,
                 name: str = "train-input"):
        self.depth = max(int(depth), 0)
        self.name = name
        self._source = iter(source)
        self._commit = commit
        self.committed = 0
        self.consumed = 0
        self.max_ahead = 0
        self.wait_s = 0.0
        self.assemble_s = 0.0
        self.commit_s = 0.0
        self._done = False
        if self.depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name=f"{THREAD_PREFIX}[{name}]",
                daemon=True)
            self._thread.start()

    def _next_committed(self) -> Any:
        t0 = time.perf_counter()
        item = next(self._source)  # StopIteration ends the walk
        t1 = time.perf_counter()
        self.assemble_s += t1 - t0
        out = self._commit(item)
        self.commit_s += time.perf_counter() - t1
        self.committed += 1
        return out

    # ---- producer (worker thread) ----

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    out = self._next_committed()
                except StopIteration:
                    break
                if not self._put((_ITEM, out)):
                    return  # closed while blocked on a full queue
            self._put((_DONE, None))
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._put((_ERROR, e))

    def _put(self, msg: tuple) -> bool:
        """Bounded put that gives up once the loader is closed, so a
        consumer that stopped pulling never leaves the worker blocked."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # ---- consumer ----

    def __iter__(self) -> "DeviceLoader":
        return self

    def __next__(self) -> Any:
        if self.depth == 0:
            t0 = time.perf_counter()
            try:
                out = self._next_committed()
            finally:
                self.wait_s += time.perf_counter() - t0
            self.consumed += 1
            return out
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        tag, val = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if tag is _DONE:
            self._done = True
            raise StopIteration
        if tag is _ERROR:
            self._done = True
            self.close()
            raise val
        self.max_ahead = max(self.max_ahead,
                             self.committed - self.consumed - 1)
        self.consumed += 1
        return val

    # ---- lifecycle ----

    def close(self) -> None:
        """Stop the worker and release the queue. Idempotent."""
        if self.depth == 0:
            return
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():  # pragma: no cover - defensive
            _log.warning("%s[%s] worker did not stop", THREAD_PREFIX,
                         self.name)

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def input_stats(loader: DeviceLoader, loop_s: float) -> dict:
    """Input wait against step time for a finished loop.
    ``input_bound_fraction`` is the share of the loop's wall clock the
    consumer spent blocked on input (about 0: the step is the bottleneck;
    about 1: the input is)."""
    wait = loader.wait_s
    loop_s = max(float(loop_s), 0.0)
    return {
        "prefetch_depth": loader.depth,
        "batches": loader.consumed,
        "committed_ahead_max": loader.max_ahead,
        "input_wait_s": wait,
        "step_s": max(loop_s - wait, 0.0),
        "input_bound_fraction": (min(wait / loop_s, 1.0)
                                 if loop_s > 0 else 0.0),
        "assemble_s": loader.assemble_s,
        "commit_s": loader.commit_s,
    }
