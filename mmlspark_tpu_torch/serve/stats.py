"""ServerStats — per-model serving metrics (the port of
``mmlspark_tpu/serve/stats.py``).

Every number is counted or timed at the seam where it happens
(admission, dispatch, drain, resolve); nothing is inferred. Counters and
bounded latency reservoirs live on the object itself, under one lock —
the JAX package's obs-plane registry is not part of this port.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


def _percentiles(values: list[float]) -> dict | None:
    """``{"p50", "p95", "p99", "n"}`` over ``values``; None when empty."""
    if not values:
        return None
    p50, p95, p99 = np.percentile(np.asarray(values, np.float64),
                                  [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "n": len(values)}


class ServerStats:
    """Thread-safe metrics surface of one served model."""

    COUNTERS = ("admitted", "completed", "rejected_overload",
                "expired_deadline", "timed_out", "failed", "batches",
                "rows_dispatched", "rows_padded", "tokens_out",
                "generate_requests", "decode_steps")

    def __init__(self, window: int = 4096, model: str = ""):
        self.model = model
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTERS, 0)
        # bounded reservoirs: the latest `window` observations
        self._e2e_ms: deque = deque(maxlen=window)
        self._queue_ms: deque = deque(maxlen=window)
        self._device_ms: deque = deque(maxlen=window)
        self._occupancy: deque = deque(maxlen=window)
        self._bucket_batches: dict[int, int] = {}
        # token serving (serve/generate.py): TTFT is prefill completion
        # minus submit (per request), ITL the gap between consecutive
        # streamed tokens (per token); slot occupancy is observed once per
        # decode step (active slots / slots)
        self._ttft_ms: deque = deque(maxlen=window)
        self._itl_ms: deque = deque(maxlen=window)
        self._slot_occupancy: deque = deque(maxlen=window)
        self._prompt_tokens: deque = deque(maxlen=window)
        # distinct batch shapes that entered the device
        self.dispatch_shapes: set = set()

    def _add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def __getattr__(self, name: str) -> int:
        if name in ServerStats.COUNTERS:
            with self._lock:
                return self._counts[name]
        raise AttributeError(name)

    # -- request side --

    def record_admitted(self) -> None:
        self._add("admitted")

    def record_rejected(self) -> None:
        self._add("rejected_overload")

    def record_expired(self) -> None:
        self._add("expired_deadline")

    def record_timeout(self) -> None:
        self._add("timed_out")

    def record_failed(self) -> None:
        self._add("failed")

    def record_done(self, e2e_ms: float, queue_ms: float) -> None:
        with self._lock:
            self._counts["completed"] += 1
            self._e2e_ms.append(e2e_ms)
            self._queue_ms.append(queue_ms)

    # -- token-serving side (serve/generate.py) --

    def record_generate_admitted(self, prompt_tokens: int) -> None:
        with self._lock:
            self._counts["generate_requests"] += 1
            self._prompt_tokens.append(prompt_tokens)

    def record_ttft(self, ms: float) -> None:
        with self._lock:
            self._ttft_ms.append(ms)

    def record_itl(self, ms: float) -> None:
        with self._lock:
            self._itl_ms.append(ms)

    def record_tokens(self, n: int = 1) -> None:
        self._add("tokens_out", n)

    def record_decode_step(self, active: int, slots: int) -> None:
        with self._lock:
            self._counts["decode_steps"] += 1
            self._slot_occupancy.append(active / slots if slots else 0.0)

    def ttft_percentiles(self) -> dict | None:
        with self._lock:
            return _percentiles(list(self._ttft_ms))

    def itl_percentiles(self) -> dict | None:
        with self._lock:
            return _percentiles(list(self._itl_ms))

    def slot_occupancy_mean(self) -> float | None:
        with self._lock:
            occ = list(self._slot_occupancy)
        return float(np.mean(occ)) if occ else None

    # -- batch side --

    def record_batch(self, bucket: int, occupancy: int, device_ms: float,
                     shapes: tuple = ()) -> None:
        with self._lock:
            self._counts["batches"] += 1
            self._counts["rows_dispatched"] += occupancy
            self._counts["rows_padded"] += max(bucket - occupancy, 0)
            self._device_ms.append(device_ms)
            self._occupancy.append(occupancy)
            self._bucket_batches[bucket] = \
                self._bucket_batches.get(bucket, 0) + 1
            self.dispatch_shapes.update(tuple(s) for s in shapes)

    def snapshot(self) -> dict:
        """One JSON-safe dict of everything measured so far. Safe before
        any traffic: empty reservoirs report ``None``."""
        with self._lock:
            out: dict = dict(self._counts)
            occupancy = list(self._occupancy)
            e2e, queue = list(self._e2e_ms), list(self._queue_ms)
            device = list(self._device_ms)
            ttft, itl = list(self._ttft_ms), list(self._itl_ms)
            slot_occ = list(self._slot_occupancy)
            prompts = list(self._prompt_tokens)
            out["occupancy_by_bucket"] = dict(
                sorted(self._bucket_batches.items()))
            out["distinct_batch_shapes"] = len(self.dispatch_shapes)
        out["batch_occupancy_mean"] = (float(np.mean(occupancy))
                                       if occupancy else None)
        out["e2e_ms"] = _percentiles(e2e)
        out["queue_wait_ms"] = _percentiles(queue)
        out["device_ms"] = _percentiles(device)
        # token-serving view (zero/None for pure batch models)
        out["ttft_ms"] = _percentiles(ttft)
        out["itl_ms"] = _percentiles(itl)
        out["slot_occupancy_mean"] = (float(np.mean(slot_occ))
                                      if slot_occ else None)
        out["prompt_tokens_mean"] = (float(np.mean(prompts))
                                     if prompts else None)
        return out
