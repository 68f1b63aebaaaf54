"""Autoregressive token serving — slot-based continuous batching (the port
of ``mmlspark_tpu/serve/generate.py``).

The serve plane's streaming traffic class, on one device:

* the KV cache is a **stateful plan segment**
  (:class:`~mmlspark_tpu_torch.core.plan.StatefulSegment`): one slot-major
  pair ``[slots, layers, heads, T_max, head_dim]`` allocated zeroed per
  engine and updated in place by every prefill and decode step;
* **prefill** packs waiting prompts of ONE length bucket
  (``GenerateConfig.prefill_buckets``) into ``prefill_rows`` rows, runs the
  full causal forward once and writes each real prompt's per-layer K/V
  into its slot. A pad row carries ``slot_id == slots``: the JAX engine
  lets XLA drop that out-of-bounds write, which in PyTorch would be a
  device assert, so the real rows are selected on the host before the
  write;
* **decode** is ONE fixed shape ``[slots]`` forever: requests join and
  leave per token step through the active mask, inactive rows keep their
  cache bits, and the per-row argmax is greedy — so a request's stream is
  **bit-identical** whether it decodes alone (:meth:`GenerateBatcher.
  oneshot`) or packed with churning neighbours (every op of the step is
  row-independent at a fixed shape; the decode-attention kernel merges
  its warps in a fixed order).

The decode loop never waits on the token it just dispatched: step *t*'s
tokens are copied (``non_blocking``) into pinned host memory behind a
CUDA event and consumed while step *t+1* runs; the carried token stays on
the device. Distinct input shapes stay ≤ ``len(prefill_buckets) + 1``
(:meth:`GenerateBatcher.program_shapes`).

Not ported yet: the ``generate_cancel`` churn fault (``serve/faults.py``),
the flight-recorder and span hooks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.serve.batcher import THREAD_PREFIX
from mmlspark_tpu_torch.serve.config import GenerateConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, Overloaded, ServerClosed,
)
from mmlspark_tpu_torch.serve.stats import ServerStats

_log = get_logger(__name__)


# ---- the two steps (built once per engine) ----

def build_prefill_step(model):
    """``(bufs, tokens [P, L], attn_mask [P, L], lengths [P], slot_ids
    [P]) -> first_token [P]`` (host arrays in, a device tensor out).

    One full causal forward over the packed prompts; every layer's K/V of
    the real rows (``slot_id < slots``) is written into the slot-major
    cache at the assigned slots, and the first token is the greedy argmax
    at each prompt's last real position."""

    def prefill_step(bufs, tokens, attn_mask, lengths, slot_ids):
        ck, cv = bufs["k"], bufs["v"]
        dev = ck.device
        length = tokens.shape[1]
        real = np.nonzero(slot_ids < ck.shape[0])[0]
        logits, (pk, pv) = model(plan._upload(tokens, dev),
                                 mask=plan._upload(attn_mask, dev),
                                 return_cache=True)
        rows = plan._upload(real.astype(np.int64), dev)
        slots = plan._upload(slot_ids[real].astype(np.int64), dev)
        ck[:, :, :, :length].index_put_((slots,), pk[rows])
        cv[:, :, :, :length].index_put_((slots,), pv[rows])
        last = plan._upload((lengths - 1).astype(np.int64), dev)
        picked = logits[torch.arange(len(lengths), device=dev), last]
        return picked.argmax(dim=-1)

    return prefill_step


def build_decode_step(model, decode_attention_fn=None):
    """``(bufs, carry [S], injected [S], inject [S], positions [S], active
    [S]) -> next_token [S]``: ``carry`` is the previous step's own output,
    a device tensor that never visits the host on the hot path; the other
    inputs are host arrays. A slot that just joined overrides ``carry``
    with its prefill token through ``inject``. The model writes the new
    token's K/V at ``positions`` (inactive rows untouched), attends
    against the cache, and the next token is the greedy per-row argmax;
    inactive rows pass their input token through."""

    def decode_step(bufs, carry, injected, inject, positions, active):
        dev = carry.device
        host = np.stack([injected, inject, positions, active]).astype(
            np.int64)
        up = plan._upload(host, dev)
        act = up[3] != 0
        tokens = torch.where(up[1] != 0, up[0], carry)
        logits, _ = model.decode_step(
            tokens[:, None], (bufs["k"], bufs["v"]), up[2],
            update_mask=torch.from_numpy(np.asarray(active, bool)),
            decode_attention_fn=decode_attention_fn)
        return torch.where(act, logits.argmax(dim=-1), tokens)

    return decode_step


# ---- per-request surfaces ----

class TokenStream:
    """Streaming handle for one generate request.

    Iterate to receive tokens as they are produced, or block on
    :meth:`result` for the full list. Terminal exactly once: finished or
    failed with one typed error."""

    __slots__ = ("model", "_cv", "_tokens", "_done", "_error")

    def __init__(self, model: str):
        self.model = model
        self._cv = threading.Condition()
        self._tokens: list[int] = []
        self._done = False
        self._error: BaseException | None = None

    # -- engine side --

    def _push(self, tok: int) -> None:
        with self._cv:
            self._tokens.append(tok)
            self._cv.notify_all()

    def _finish(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def _fail(self, err: BaseException) -> None:
        with self._cv:
            self._error = err
            self._done = True
            self._cv.notify_all()

    # -- client side --

    @property
    def done(self) -> bool:
        with self._cv:
            return self._done

    @property
    def tokens(self) -> list[int]:
        """Snapshot of everything streamed so far."""
        with self._cv:
            return list(self._tokens)

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while len(self._tokens) <= i and not self._done:
                    self._cv.wait()
                if len(self._tokens) > i:
                    tok = self._tokens[i]
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield tok
            i += 1

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until terminal; the full token list, or the typed
        error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._done:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"model {self.model!r}: stream not terminal "
                        f"within {timeout}s")
                self._cv.wait(rem)
            if self._error is not None:
                raise self._error
            return list(self._tokens)


class GenerateRequest:
    """Engine-internal state of one admitted generate request."""

    __slots__ = ("prompt", "max_new", "stream", "slot", "emitted",
                 "steps_done", "steps_needed", "done", "submitted",
                 "last_token_t")

    def __init__(self, prompt: list[int], max_new: int,
                 stream: TokenStream):
        self.prompt = prompt
        self.max_new = max_new
        self.stream = stream
        self.slot: int | None = None
        self.emitted = 0
        self.steps_done = 0
        self.steps_needed = max_new - 1  # prefill delivers token 1
        self.done = False
        self.submitted = time.monotonic()
        self.last_token_t = self.submitted


class SlotTable:
    """Slot ownership ledger — the no-double-assignment invariant.

    Assignment and release are the ONLY mutation points; a slot handed
    out while still owned, or released by a non-owner, is an engine bug
    that raises instead of corrupting the cache."""

    __slots__ = ("_owner",)

    def __init__(self, slots: int):
        self._owner: list[GenerateRequest | None] = [None] * slots

    def assign(self, req: GenerateRequest) -> int | None:
        """First free slot (None when full)."""
        for s, owner in enumerate(self._owner):
            if owner is None:
                if req.slot is not None:
                    raise RuntimeError(
                        f"request already owns slot {req.slot}")
                self._owner[s] = req
                req.slot = s
                return s
        return None

    def release(self, req: GenerateRequest) -> None:
        s = req.slot
        if s is None or self._owner[s] is not req:
            raise RuntimeError(
                f"slot release by non-owner (slot={s}) — "
                "double-assignment or double-release")
        self._owner[s] = None
        req.slot = None

    @property
    def free(self) -> int:
        return sum(1 for o in self._owner if o is None)

    def owner(self, s: int) -> GenerateRequest | None:
        return self._owner[s]


class GenerateBatcher:
    """Continuous-batching token engine for ONE causal model.

    ``model`` is a causal :class:`~mmlspark_tpu_torch.models.sequence.
    TransformerTagger`; ``state_dict`` (optional) is loaded into it, and
    it is moved to ``device`` (None = cuda, which raises without a card).
    The engine owns the slot-major KV cache, packs waiting prompts through
    the prefill ladder, and runs the fixed-shape decode step with per-step
    join and leave. One engine thread does everything in order, so slot
    assignment needs no cross-thread protocol; the :class:`SlotTable`
    still raises if that order is ever broken."""

    def __init__(self, name: str, model: Any, state_dict: Any = None,
                 config: GenerateConfig | None = None,
                 decode_attention_fn: Any = None, device: Any = None):
        if not getattr(model, "causal", False):
            raise BadRequest(
                f"model {name!r}: token generation needs a causal "
                "model (causal=True)")
        self.name = name
        self.config = cfg = config or GenerateConfig()
        if cfg.t_max > model.max_len:
            raise BadRequest(
                f"model {name!r}: cache horizon t_max={cfg.t_max} exceeds "
                f"the model's {model.max_len} positions")
        self.device = resolve_device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.stats = ServerStats(cfg.stats_window, model=name)
        S = cfg.slots
        shape = (S, model.num_layers, model.num_heads, cfg.t_max,
                 model.embed_dim // model.num_heads)
        self._state = plan.allocate_segment_state(
            f"{name}.kv", {"k": shape, "v": shape}, self.device)
        self._prefill = plan.StatefulSegment(
            "generate.prefill", build_prefill_step(self.model), self._state)
        self._decode = plan.StatefulSegment(
            "generate.decode",
            build_decode_step(self.model, decode_attention_fn), self._state)
        # host mirror of the device-side slot state (engine thread only
        # once running)
        self._slots = SlotTable(S)
        self._positions = np.zeros(S, np.int64)
        self._inject_tok = np.zeros(S, np.int64)
        self._inject = np.zeros(S, bool)
        self._mask = np.zeros(S, bool)
        self._carry = torch.zeros(S, dtype=torch.long, device=self.device)
        # lagged-consume state: (host tokens, event, per-slot request refs
        # at dispatch time, active snapshot)
        self._pending: tuple | None = None
        self._cv = threading.Condition()
        self._queue: deque[GenerateRequest] = deque()
        self._closed = False
        self._abort = False
        self._thread = threading.Thread(
            target=self._run, name=f"{THREAD_PREFIX}[{name}]/generate",
            daemon=True)
        self._thread.start()

    # -- admission --

    def submit(self, prompt, max_new_tokens: int | None = None
               ) -> TokenStream:
        """Admit one prompt; returns its :class:`TokenStream`."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise BadRequest(f"model {self.name!r}: empty prompt")
        max_new = (self.config.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise BadRequest(
                f"model {self.name!r}: max_new_tokens must be >= 1")
        self.config.prefill_bucket_for(len(prompt), self.name)
        if len(prompt) + max_new > self.config.t_max:
            raise BadRequest(
                f"model {self.name!r}: prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new}) exceeds the cache horizon "
                f"t_max={self.config.t_max}")
        if min(prompt) < 0 or max(prompt) >= self.model.vocab_size:
            raise BadRequest(
                f"model {self.name!r}: token ids must lie in "
                f"[0, {self.model.vocab_size})")
        stream = TokenStream(self.name)
        req = GenerateRequest(prompt, max_new, stream)
        with self._cv:
            if self._closed:
                raise ServerClosed(
                    f"model {self.name!r} is shutting down",
                    retry_after_s=self.config.retry_after_s)
            if len(self._queue) >= self.config.max_queue:
                self.stats.record_rejected()
                raise Overloaded(self.name, len(self._queue),
                                 self.config.max_queue,
                                 retry_after_s=self.config.retry_after_s)
            self._queue.append(req)
            self.stats.record_generate_admitted(len(prompt))
            self._cv.notify()
        return stream

    @property
    def queued(self) -> int:
        with self._cv:
            return len(self._queue)

    def program_shapes(self) -> int:
        """Distinct input shapes the two steps have run — the counterpart
        of the JAX engine's compiled-program budget (≤ prefill buckets +
        1)."""
        return len(self._prefill.shapes) + len(self._decode.shapes)

    # -- the engine loop --

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._loop()
            else:
                self._loop()
        except BaseException as e:  # noqa: BLE001 — no stranded stream
            _log.exception("GenerateBatcher[%s] engine loop died",
                           self.name)
            self._fail_outstanding(e)

    def _fail_outstanding(self, err: BaseException) -> None:
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
            active = [self._slots.owner(s)
                      for s in range(self.config.slots)]
        for req in leftovers + [r for r in active if r is not None]:
            if not req.done:
                req.done = True
                req.stream._fail(err)
                self.stats.record_failed()

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._abort:
                    break
            worked = False
            group = self._next_prefill_group()
            if group:
                self._do_prefill(group)
                worked = True
            if self._mask.any():
                self.advance_decode()
                worked = True
            elif self._pending is not None:
                # trailing lagged output after the last active slot left
                self._consume(self._pending)
                self._pending = None
                worked = True
            if worked:
                continue
            with self._cv:
                if self._queue:
                    continue  # raced with a submit
                if self._closed or self._abort:
                    break
                self._cv.wait()
        self._shutdown_flush()

    def _shutdown_flush(self) -> None:
        """Terminal sweep: every admitted request must resolve."""
        if self._pending is not None:
            self._consume(self._pending)
            self._pending = None
        err = ServerClosed(f"model {self.name!r} closed")
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
        for req in leftovers:
            req.done = True
            req.stream._fail(err)
            self.stats.record_failed()
        for s in range(self.config.slots):
            req = self._slots.owner(s)
            if req is not None and not req.done:
                req.done = True
                self._mask[s] = False
                self._slots.release(req)
                req.stream._fail(err)
                self.stats.record_failed()

    def _next_prefill_group(self) -> list[GenerateRequest]:
        """FIFO prompts sharing ONE prefill bucket, up to the free-slot
        and row-width caps: a prompt goes through the same prefill shape
        whether it prefills alone or packed."""
        cfg = self.config
        group: list[GenerateRequest] = []
        with self._cv:
            cap = min(self._slots.free, cfg.prefill_rows)
            bucket = None
            while self._queue and len(group) < cap:
                req = self._queue[0]
                b = cfg.prefill_bucket_for(len(req.prompt), self.name)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break
                self._queue.popleft()
                group.append(req)
        return group

    def _prefill_inputs(self, prompts: list[list[int]], slots: list[int]
                        ) -> tuple:
        """The prefill step's host inputs: ``prefill_rows`` rows padded to
        the prompts' bucket; pad rows carry ``slot_id == slots``."""
        cfg = self.config
        bucket = cfg.prefill_bucket_for(len(prompts[0]), self.name)
        P = cfg.prefill_rows
        toks = np.zeros((P, bucket), np.int64)
        am = np.zeros((P, bucket), bool)
        lengths = np.ones(P, np.int64)
        slot_ids = np.full(P, cfg.slots, np.int64)
        for r, (prompt, s) in enumerate(zip(prompts, slots)):
            n = len(prompt)
            toks[r, :n] = prompt
            am[r, :n] = True
            lengths[r] = n
            slot_ids[r] = s
        return toks, am, lengths, slot_ids

    def _do_prefill(self, group: list[GenerateRequest]) -> None:
        cfg = self.config
        with self._cv:
            slots = [self._slots.assign(req) for req in group]
        try:
            first = self._prefill.dispatch(*self._prefill_inputs(
                [req.prompt for req in group], slots))
            # prefill is the TTFT seam, not the decode loop: this blocking
            # fetch is what time-to-first-token means
            vals = first.cpu().numpy()
        except BaseException as e:  # noqa: BLE001 — relayed per stream
            with self._cv:
                for req in group:
                    req.done = True
                    self._slots.release(req)
            for req in group:
                req.stream._fail(e)
                self.stats.record_failed()
            return
        now = time.monotonic()
        for r, req in enumerate(group):
            tok = int(vals[r])
            self.stats.record_ttft((now - req.submitted) * 1e3)
            req.stream._push(tok)
            req.emitted = 1
            req.last_token_t = now
            self.stats.record_tokens(1)
            s = req.slot
            if req.max_new == 1 or tok == cfg.eos_token:
                self._retire(req, now)
                continue
            self._positions[s] = len(req.prompt)
            self._inject_tok[s] = tok
            self._inject[s] = True
            self._mask[s] = True

    def advance_decode(self) -> None:
        """One token step: dispatch the fixed-shape decode step over the
        current slot state, then consume the PREVIOUS step's output (the
        one-step-lagged fetch: step *t+1* runs while step *t*'s tokens
        stream out)."""
        S = self.config.slots
        act = self._mask.copy()
        refs = [self._slots.owner(s) for s in range(S)]
        out = self._decode.dispatch(self._carry, self._inject_tok,
                                    self._inject, self._positions, act)
        self._carry = out
        self._inject[:] = False
        self.stats.record_decode_step(int(act.sum()), S)
        for s in np.nonzero(act)[0]:
            req = refs[s]
            self._positions[s] += 1
            req.steps_done += 1
            if req.steps_done >= req.steps_needed:
                # generation budget reached: this dispatch was the
                # request's last; the lagged consume retires it
                self._mask[s] = False
        (host,), event = plan._issue_fetch((out,))
        prev, self._pending = self._pending, (host, event, refs, act)
        if prev is not None:
            self._consume(prev)

    def _consume(self, pending: tuple) -> None:
        host, event, refs, act = pending
        if event is not None:
            event.synchronize()
        vals = host.numpy()
        now = time.monotonic()
        cfg = self.config
        for s in np.nonzero(act)[0]:
            req = refs[s]
            if req is None or req.done:
                continue
            tok = int(vals[s])
            req.stream._push(tok)
            self.stats.record_itl((now - req.last_token_t) * 1e3)
            self.stats.record_tokens(1)
            req.last_token_t = now
            req.emitted += 1
            if req.emitted >= req.max_new or tok == cfg.eos_token:
                self._retire(req, now)

    def _retire(self, req: GenerateRequest, now: float) -> None:
        req.done = True
        with self._cv:
            if req.slot is not None:
                self._mask[req.slot] = False
                self._slots.release(req)
        req.stream._finish()
        self.stats.record_done((now - req.submitted) * 1e3, 0.0)

    # -- the one-shot reference (the bit-identity anchor) --

    def oneshot(self, prompt, max_new_tokens: int | None = None
                ) -> list[int]:
        """Whole-sequence decode of one prompt through the SAME two steps
        on FRESH zero buffers (no engine state touched, no stats): prefill
        alone, then decode alone to the budget, one synchronous fetch per
        token. Every continuously batched stream must equal it bit for
        bit."""
        cfg = self.config
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        max_new = (cfg.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        S = cfg.slots
        shape = self._state.buffers["k"].shape
        bufs = {"k": torch.zeros(shape, device=self.device),
                "v": torch.zeros(shape, device=self.device)}
        first = self._prefill.run(bufs,
                                  *self._prefill_inputs([prompt], [0]))
        tokens = [int(first[0])]
        if max_new == 1 or tokens[0] == cfg.eos_token:
            return tokens
        carry = torch.zeros(S, dtype=torch.long, device=self.device)
        inject_tok = np.zeros(S, np.int64)
        inject = np.zeros(S, bool)
        positions = np.zeros(S, np.int64)
        active = np.zeros(S, bool)
        inject_tok[0] = tokens[0]
        inject[0] = True
        positions[0] = len(prompt)
        active[0] = True
        for _ in range(max_new - 1):
            carry = self._decode.run(bufs, carry, inject_tok, inject,
                                     positions, active)
            inject[0] = False
            positions[0] += 1
            tok = int(carry[0])
            tokens.append(tok)
            if tok == cfg.eos_token:
                break
        return tokens

    # -- lifecycle --

    def close(self, drain: bool = True) -> None:
        """Stop admission; ``drain=True`` finishes every admitted stream
        first, ``drain=False`` fails outstanding work typed. Idempotent;
        joins the engine thread."""
        with self._cv:
            self._closed = True
            if not drain:
                self._abort = True
            self._cv.notify_all()
        self._thread.join(timeout=self.config.drain_timeout_s)
        if self._thread.is_alive():  # pragma: no cover - defensive
            _log.warning("GenerateBatcher[%s] did not stop within %.1fs",
                         self.name, self.config.drain_timeout_s)
