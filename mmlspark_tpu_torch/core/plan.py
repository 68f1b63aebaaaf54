"""The device plan: fuse adjacent device stages into one forward per
minibatch (the port of ``mmlspark_tpu/core/plan.py`` on one device).

A host pipeline walks its stages one at a time, so a device-heavy chain
(image transform → featurize → score) pays a host↔device round trip per
stage. The planner partitions a stage list into maximal runs of
:class:`~mmlspark_tpu_torch.core.stage.DeviceStage` stages whose
``device_fn`` accepts the incoming layout, and runs each run as ONE
composite forward per minibatch:

* the entry column is stacked into one ``[N, ...]`` host array (the raw
  uint8 pixels for an image column) and cut into fixed-size minibatches,
  the tail padded with zeros;
* each minibatch is ONE upload (pinned memory, ``non_blocking``), every
  stage's op runs on the device tensor in turn, and every column the run
  writes is copied back in ONE fetch round (pinned memory,
  ``non_blocking``, one CUDA event behind the copies), so the call returns
  once the work is *enqueued*;
* at most ``MAX_INFLIGHT`` minibatch outputs are outstanding: the oldest
  is waited on (its event) before another is enqueued;
* each written column is emitted by the stage that wrote it last, so the
  fused table is column for column the stage-by-stage result.

On a CPU target the same code runs synchronously (no pinning, no events).

Fallback rules, which are part of the semantics (the same stages run
their own ``transform``, which for a model stage is still on the device):

* a stage that is not a ``DeviceStage``, or whose ``device_fn`` declines
  the incoming :class:`~mmlspark_tpu_torch.core.stage.ArrayMeta`, runs on
  the host;
* :func:`execute_stages` needs ≥ 2 consecutive device stages: a lone
  device stage keeps its own ``transform``; :func:`transform_async`
  (serving) dispatches a trailing segment of any length;
* entry coercion is strict: rows must be present and share one
  shape/dtype (no ragged images), else the segment runs on the host;
* an empty table runs on the host.

A segment that coerces but fails to run raises: it never falls back.

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

import contextlib
import threading
import weakref
from collections import deque
from typing import Any, Callable, Iterator

import numpy as np
import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger, timed
from mmlspark_tpu_torch.core.schema import is_image_column
from mmlspark_tpu_torch.core.stage import ArrayMeta, DeviceOp, DeviceStage
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.device import resolve_device

_log = get_logger(__name__)

# outstanding minibatch outputs per dispatch: bounds device memory on
# very large tables
MAX_INFLIGHT = 8
# a segment's minibatch when none of its stages sets one
DEFAULT_MINIBATCH = 64


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


# ---- the crossings: every upload and fetch of the minibatch pipeline goes
#      through these two functions, so count_crossings sees them all ----

def _upload(chunk: np.ndarray, device: torch.device) -> torch.Tensor:
    """ONE host→device transfer of one minibatch, from pinned memory."""
    host = torch.from_numpy(np.ascontiguousarray(chunk))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _issue_fetch(outs: tuple
                 ) -> tuple[list[torch.Tensor], torch.cuda.Event | None]:
    """ONE async device→host fetch round for one minibatch's outputs, into
    pinned memory; returns the host tensors and the event that marks them
    filled."""
    if not outs[0].is_cuda:
        return list(outs), None
    hosts = []
    for out in outs:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        hosts.append(host)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


class CrossingCounter:
    """Tally of the crossings :func:`count_crossings` observed."""

    def __init__(self) -> None:
        self.uploads = 0        # host→device transfers (one a minibatch)
        self.fetches = 0        # device→host fetch rounds (one a minibatch)
        self.upload_bytes = 0   # host→device payload: a fused run ships
        #                         the entry form (uint8 pixels)
        self.upload_shapes: set = set()  # distinct batch shapes uploaded


@contextlib.contextmanager
def count_crossings():
    """Count the uploads and fetch rounds the minibatch pipeline issues, by
    patching this module's ``_upload``/``_issue_fetch``. Not thread-safe:
    use from single-threaded callers."""
    global _upload, _issue_fetch
    counter = CrossingCounter()
    orig_upload, orig_fetch = _upload, _issue_fetch

    def counting_upload(chunk, device):
        counter.uploads += 1
        counter.upload_bytes += int(chunk.nbytes)
        counter.upload_shapes.add(tuple(chunk.shape))
        return orig_upload(chunk, device)

    def counting_fetch(outs):
        counter.fetches += 1
        return orig_fetch(outs)

    _upload, _issue_fetch = counting_upload, counting_fetch
    try:
        yield counter
    finally:
        _upload, _issue_fetch = orig_upload, orig_fetch


def place(params: Any, device: torch.device) -> Any:
    """``params`` on ``device``: a module is moved in place (when it is not
    there yet) and put in eval mode, tensors and numpy arrays are copied,
    lists, tuples and dicts are placed item by item."""
    if isinstance(params, torch.nn.Module):
        first = next(iter(params.parameters()), None)
        if first is None or first.device != device:
            params.to(device)
        return params.eval()
    if isinstance(params, np.ndarray):
        return torch.from_numpy(params).to(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, (list, tuple)):
        return type(params)(place(p, device) for p in params)
    if isinstance(params, dict):
        return {k: place(v, device) for k, v in params.items()}
    return params


def _windowed_dispatch(fn: Callable, params: Any, batch: np.ndarray,
                       size: int, device: torch.device, max_inflight: int
                       ) -> tuple[list, list, Callable[[], None]]:
    """Enqueue ``fn(params, minibatch)`` over every minibatch of ``batch``,
    waiting on the oldest fetch whenever ``max_inflight`` are outstanding.
    Returns ``(pieces, shapes, drain_rest)``: ``pieces`` receives one list
    of trimmed host arrays (one per output) per drained minibatch, in
    order; ``shapes`` the uploaded shapes; ``drain_rest()`` waits for the
    rest — callers choose when to pay it."""
    window: deque = deque()
    pieces: list[list[np.ndarray]] = []
    shapes: list[tuple] = []
    inflight = max(1, int(max_inflight))

    def drain_one() -> None:
        hosts, event, valid = window.popleft()
        if event is not None:
            event.synchronize()
        # copies, so results handed to callers never pin host memory
        pieces.append([h.numpy()[:valid].copy() for h in hosts])

    for chunk, valid in minibatches(batch, size):
        shapes.append(tuple(chunk.shape))
        outs = fn(params, _upload(chunk, device))
        if not isinstance(outs, tuple):
            outs = (outs,)
        window.append((*_issue_fetch(outs), valid))
        while len(window) > inflight:
            drain_one()

    def drain_rest() -> None:
        while window:
            drain_one()

    return pieces, shapes, drain_rest


def _assemble_outputs(pieces: list) -> list[np.ndarray]:
    """Per-minibatch ``pieces`` → one concatenated host array per output."""
    if not pieces:
        return []
    return [np.concatenate([p[k] for p in pieces])
            if len(pieces) > 1 else pieces[0][k]
            for k in range(len(pieces[0]))]


def pipeline_minibatches(fn: Callable, params: Any, batch: np.ndarray,
                         size: int, device: torch.device,
                         max_inflight: int = MAX_INFLIGHT
                         ) -> list[np.ndarray]:
    """Run ``fn(params, minibatch)`` over ``batch``: the upload of
    minibatch i+1 and the fetch of i-1 overlap the compute of i. ``fn``
    may return one tensor or a tuple; returns one trimmed, concatenated
    host array per output."""
    pieces, _, drain_rest = _windowed_dispatch(fn, params, batch, size,
                                               device, max_inflight)
    drain_rest()
    return _assemble_outputs(pieces)


# ---- segment entry: host column → one stacked array ----

def stack_image_column(col: np.ndarray
                       ) -> tuple[np.ndarray, list[str]] | None:
    """Stack an image-struct column into one ``[N,H,W,C]`` uint8 batch;
    returns ``(batch, paths)`` or None when rows are missing, ragged, or
    not uint8 (host path)."""
    datas, paths = [], []
    for v in col:
        if not isinstance(v, dict):
            return None
        d = np.asarray(v["data"])
        if d.ndim == 2:
            d = d[:, :, None]
        datas.append(d)
        paths.append(v.get("path", ""))
    if not datas:
        return None
    shape, dtype = datas[0].shape, datas[0].dtype
    if dtype != np.uint8 or any(
            d.shape != shape or d.dtype != dtype for d in datas):
        return None
    return np.stack(datas), paths


def _entry_meta(table: DataTable, col: str) -> ArrayMeta | None:
    """A first-row probe at planning time; :func:`_coerce_entry` validates
    every row at execution time."""
    if col not in table.columns or len(table) == 0:
        return None
    if is_image_column(table, col):
        v = table[col][0]
        if not isinstance(v, dict):
            return None
        d = np.asarray(v["data"])
        if d.dtype != np.uint8:
            return None
        shape = d.shape if d.ndim == 3 else d.shape + (1,)
        return ArrayMeta(tuple(shape), "uint8", is_image=True)
    arr = table[col]
    if arr.dtype == object:
        first = arr[0]
        if first is None:
            return None
        f = np.asarray(first)
        if not np.issubdtype(f.dtype, np.number):
            return None
        dt = "uint8" if f.dtype == np.uint8 else "float32"
        return ArrayMeta((int(f.size),), dt)
    if not np.issubdtype(arr.dtype, np.number):
        return None
    return ArrayMeta((1,), "float32")


def _coerce_entry(table: DataTable, col: str, meta: ArrayMeta
                  ) -> tuple[np.ndarray, dict] | None:
    """The segment's entry column as one contiguous array matching
    ``meta``; None on any mismatch (the segment runs on the host)."""
    if meta.is_image:
        stacked = stack_image_column(table[col])
        if stacked is None:
            return None
        batch, paths = stacked
        if batch.shape[1:] != tuple(meta.shape):
            return None
        return batch, {"paths": paths}
    try:
        batch = table.column_matrix(col, dtype=np.dtype(meta.dtype))
    except (TypeError, ValueError):
        return None
    if batch.shape[1:] != tuple(meta.shape):
        return None
    return batch, {}


# ---- planning: greedy maximal runs of device stages ----

# device_fn results memoized per stage (weak keys, so nothing lands in a
# stage's __dict__ and pickling is untouched): planning runs on every
# transform, and a model stage's device_fn traces its forward on the meta
# device
_DEVICE_FN_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _stage_device_fn(s: DeviceStage, meta: ArrayMeta) -> DeviceOp | None:
    """The stage's device op for ``meta``, memoized on its cache token."""
    key = (s.device_cache_token(), meta)
    hit = _DEVICE_FN_MEMO.get(s)
    if hit is not None and hit[0] == key:
        return hit[1]
    op = s.device_fn(meta)
    _DEVICE_FN_MEMO[s] = (key, op)
    return op


class _Segment:
    """A maximal run of device stages rooted at ``stages[start]``."""

    def __init__(self, start: int, stages: list, entry_col: str,
                 entry_meta: ArrayMeta, metas_in: list[ArrayMeta],
                 out_cols: list[str], emitters: dict[str, int],
                 out_metas: dict[str, ArrayMeta]):
        self.start = start
        self.stages = stages
        self.entry_col = entry_col
        self.entry_meta = entry_meta
        self.metas_in = metas_in          # per-stage input meta
        self.out_cols = out_cols          # first-write order
        self.emitters = emitters          # out col → index of last writer
        self.out_metas = out_metas        # out col → final meta

    @property
    def end(self) -> int:
        return self.start + len(self.stages)


def collect_segment(stages: list, i: int,
                    meta_of: Callable[[str], ArrayMeta | None],
                    explain: list | None = None,
                    min_stages: int = 2) -> _Segment | None:
    """Root a maximal device segment at ``stages[i]``, resolving the entry
    column's layout through ``meta_of``. ``explain``, when given, collects
    the reasons the segment broke or never formed. ``min_stages`` is 2 for
    batch execution (a lone device stage keeps its own ``transform``) and
    1 for the serving entry (:func:`transform_async`), where the win is
    the asynchronous dispatch itself."""

    def note(msg: str) -> None:
        if explain is not None:
            explain.append(msg)

    s0 = stages[i]
    if not isinstance(s0, DeviceStage):
        note(f"stage {i} ({type(s0).__name__}) is not a DeviceStage")
        return None
    entry_col = s0.device_input_col()
    if entry_col is None:
        note(f"stage {i} ({type(s0).__name__}) declines device execution "
             "for its current configuration (no device input column)")
        return None
    entry_meta = meta_of(entry_col)
    if entry_meta is None:
        note(f"stage {i} ({type(s0).__name__}): entry column "
             f"{entry_col!r} has no device-coercible layout "
             "(missing, ragged, non-numeric, or unknown shape)")
        return None
    env: dict[str, ArrayMeta] = {entry_col: entry_meta}
    seg_stages: list = []
    metas_in: list[ArrayMeta] = []
    out_cols: list[str] = []
    emitters: dict[str, int] = {}
    out_metas: dict[str, ArrayMeta] = {}
    j = i
    while j < len(stages):
        s = stages[j]
        if not isinstance(s, DeviceStage):
            note(f"segment breaks at stage {j}: {type(s).__name__} "
                 "is not a DeviceStage")
            break
        in_col = s.device_input_col()
        out_col = s.device_output_col()
        if in_col is None or out_col is None:
            note(f"segment breaks at stage {j}: {type(s).__name__} "
                 "declines device execution (no device input/output column)")
            break
        if in_col not in env:
            note(f"segment breaks at stage {j}: input column {in_col!r} "
                 "is not device-resident (host-produced columns are never "
                 "re-uploaded mid-run)")
            break
        op = _stage_device_fn(s, env[in_col])
        if op is None:
            note(f"segment breaks at stage {j}: "
                 f"{type(s).__name__}.device_fn declined the incoming "
                 f"layout {env[in_col]}")
            break
        metas_in.append(env[in_col])
        seg_stages.append(s)
        env[out_col] = op.out_meta
        if out_col not in emitters:
            out_cols.append(out_col)
        emitters[out_col] = j - i
        out_metas[out_col] = op.out_meta
        j += 1
    if len(seg_stages) < max(1, int(min_stages)):
        if len(seg_stages) == 1:
            note(f"stage {i} ({type(s0).__name__}) is a lone device stage "
                 "(a segment needs >= 2): it keeps its own transform path")
        return None
    return _Segment(i, seg_stages, entry_col, entry_meta, metas_in,
                    out_cols, emitters, out_metas)


def _collect_segment(stages: list, i: int, table: DataTable
                     ) -> _Segment | None:
    return collect_segment(stages, i, lambda col: _entry_meta(table, col))


def describe_plan(stages: list, table: DataTable) -> list[tuple[str, list]]:
    """The segment structure the executor would use on ``table``:
    ``[("device"|"host", [stage, ...]), ...]``. For introspection: a
    segment whose entry column a not-yet-run host stage writes shows as
    host here but may still fuse at execution time."""
    out: list[tuple[str, list]] = []
    i = 0
    while i < len(stages):
        seg = _collect_segment(stages, i, table)
        if seg is None:
            out.append(("host", [stages[i]]))
            i += 1
        else:
            out.append(("device", list(seg.stages)))
            i = seg.end
    return out


# ---- composition and execution ----

def _segment_tokens(seg: _Segment) -> tuple:
    return tuple(s.device_cache_token() for s in seg.stages)


def segment_composite(seg: _Segment) -> tuple[Callable, tuple]:
    """(composite fn, params tuple) for a fused segment: the composite
    threads the entry tensor through every stage's op, under
    ``torch.inference_mode``, and returns one tensor per written column,
    so fusion never changes which columns exist — only how many crossings
    they cost."""
    ops: list[DeviceOp] = []
    for s, meta_in in zip(seg.stages, seg.metas_in):
        op = _stage_device_fn(s, meta_in)
        if op is None:  # config changed between planning and compile
            raise RuntimeError(
                f"{type(s).__name__}.device_fn declined at compile time")
        ops.append(op)
    in_cols = [s.device_input_col() for s in seg.stages]
    out_cols_per_stage = [s.device_output_col() for s in seg.stages]

    def composite(all_params: tuple, x: torch.Tensor) -> tuple:
        vals = {seg.entry_col: x}
        with torch.inference_mode():
            for k, op in enumerate(ops):
                vals[out_cols_per_stage[k]] = op.fn(all_params[k],
                                                    vals[in_cols[k]])
        return tuple(vals[c] for c in seg.out_cols)

    return composite, tuple(op.params for op in ops)


def _segment_device(seg: _Segment) -> torch.device:
    """The device a fused run uses: the one its stages name (they must
    agree), else the default (``cuda``; raises without a card)."""
    named = {s.device for s in seg.stages
             if getattr(s, "device", None) is not None}
    if len(named) > 1:
        raise ValueError(
            f"the stages of one device segment name different devices: "
            f"{sorted(named)}")
    return resolve_device(next(iter(named), None))


def _compile_segment(seg: _Segment) -> tuple:
    """(composite, params on the device, device)."""
    device = _segment_device(seg)
    composite, params = segment_composite(seg)
    return composite, place(params, device), device


def _segment_minibatch(seg: _Segment) -> tuple[int, int]:
    """(minibatch size, max_inflight) for a fused run: the smallest
    explicit stage setting wins (it is a memory bound)."""
    sizes = [int(s.minibatch_size) for s in seg.stages
             if getattr(s, "minibatch_size", None)]
    size = min(sizes) if sizes else DEFAULT_MINIBATCH
    inflights = [int(s.max_inflight) for s in seg.stages
                 if getattr(s, "max_inflight", None)]
    return size, (min(inflights) if inflights else MAX_INFLIGHT)


def predict_segment_minibatches(seg: _Segment, n_rows: int) -> int:
    """How many fixed-shape minibatches a fused run of ``seg`` over
    ``n_rows`` rows costs: one upload and one fetch round each."""
    if n_rows <= 0:
        return 0
    size = min(_segment_minibatch(seg)[0], n_rows)
    return -(-n_rows // size)


# cached segments per cache_host, LRU-capped so streaming sources with
# many entry shapes cannot pin an unbounded number of entries
_PLAN_CACHE_MAX = 8


def _cached_segment(seg: _Segment, cache_host: Any) -> tuple:
    """(composite, device params, device) for ``seg``, through
    ``cache_host``'s LRU-capped segment cache when one is given: repeated
    transforms on one pipeline reuse one composite and one placement. A
    changed cache token of any stage rebuilds the entry."""
    if cache_host is None:
        return _compile_segment(seg)
    key = (tuple(id(s) for s in seg.stages), seg.entry_col, seg.entry_meta)
    lock = cache_host.__dict__.setdefault("_plan_lock", threading.Lock())
    with lock:
        store = cache_host.__dict__.setdefault("_plan_cache", {})
        entry = store.get(key)
        tokens = _segment_tokens(seg)
        if entry is not None and entry[0] != tokens:
            entry = None  # stage config changed: rebuild
        if entry is None:
            # pin the stage objects so their id()-based key cannot be reused
            entry = (tokens, _compile_segment(seg), tuple(seg.stages))
        else:
            del store[key]  # re-insert: LRU order = insertion order
        store[key] = entry
        while len(store) > _PLAN_CACHE_MAX:
            store.pop(next(iter(store)))
    return entry[1]


def _emit(seg: _Segment, table: DataTable, host: list[np.ndarray],
          ctx: dict) -> DataTable:
    for col, values in zip(seg.out_cols, host):
        emitter = seg.stages[seg.emitters[col]]
        table = emitter.device_emit(table, values, seg.out_metas[col], ctx)
    return table


def _label(seg: _Segment) -> str:
    return "FusedSegment[" + "→".join(type(s).__name__
                                      for s in seg.stages) + "]"


def _run_segment(seg: _Segment, table: DataTable,
                 cache_host: Any) -> DataTable | None:
    """Execute a fused segment; None if entry coercion fails (host path)."""
    coerced = _coerce_entry(table, seg.entry_col, seg.entry_meta)
    if coerced is None:
        return None
    batch, ctx = coerced
    size, max_inflight = _segment_minibatch(seg)
    fn, params, device = _cached_segment(seg, cache_host)
    with timed(_label(seg), _log, len(table)):
        outs = pipeline_minibatches(fn, params, batch,
                                    min(size, len(batch)), device,
                                    max_inflight)
    return _emit(seg, table, outs, ctx)


class PendingTable:
    """Handle for an asynchronously dispatched transform.

    ``result()`` waits for the device→host copies, emits the output
    columns and returns the finished :class:`DataTable`; it is idempotent.
    A PendingTable built from a finished table (the host path) returns it
    at once. ``shapes`` holds the batch shapes uploaded to the device
    (empty for the host path). Single consumer: the serve batcher's
    in-flight window owns each handle."""

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


def dispatch_segment(seg: _Segment, table: DataTable, cache_host: Any
                     ) -> tuple[Callable[[], DataTable], tuple] | None:
    """Enqueue ``seg`` over one packed batch and return at once with
    ``(finish, uploaded shapes)``; None when entry coercion declines.

    A batch at or below the stages' minibatch bound — the serving case,
    since bucket ladders are sized to fit — is ONE minibatch: one upload,
    one composite forward, one fetch round. A larger one is cut at that
    bound, the tail padded, with at most ``max_inflight`` outputs
    outstanding. ``finish()`` waits, trims the padding and emits the
    columns."""
    coerced = _coerce_entry(table, seg.entry_col, seg.entry_meta)
    if coerced is None:
        return None
    batch, ctx = coerced
    fn, params, device = _cached_segment(seg, cache_host)
    bound, max_inflight = _segment_minibatch(seg)
    pieces, shapes, drain_rest = _windowed_dispatch(
        fn, params, batch, min(bound, len(batch)), device, max_inflight)

    def finish() -> DataTable:
        drain_rest()
        return _emit(seg, table, _assemble_outputs(pieces), ctx)

    return finish, tuple(shapes)


def transform_async(stages: list, table: DataTable,
                    cache_host: Any = None) -> PendingTable:
    """Run a fitted-transformer list over one packed batch, dispatching
    the *trailing* device segment (of any length ≥ 1, a lone model stage
    included) asynchronously: the serving execution engine. Everything
    else runs as :func:`execute_stages` runs it. ``result()`` on the
    returned handle pays the fetch."""
    stages = list(stages)
    i = 0
    while i < len(stages):
        seg = None
        if len(table):
            seg = collect_segment(stages, i,
                                  lambda col: _entry_meta(table, col),
                                  min_stages=1)
        if seg is not None:
            if seg.end == len(stages):
                dispatched = dispatch_segment(seg, table, cache_host)
                if dispatched is not None:
                    finish, shapes = dispatched
                    return PendingTable(finish=finish, shapes=shapes)
            elif len(seg.stages) >= 2:
                fused = _run_segment(seg, table, cache_host)
                if fused is not None:
                    table = fused
                    i = seg.end
                    continue
        table = stages[i].transform(table)
        i += 1
    return PendingTable(table=table)


def execute_stages(stages: list, table: DataTable,
                   cache_host: Any = None) -> DataTable:
    """Run a fitted-transformer list over ``table``, fusing maximal runs of
    device stages (the :class:`PipelineModel` engine). ``cache_host``
    (typically the owning PipelineModel) carries the segment cache across
    calls."""
    i = 0
    while i < len(stages):
        seg = None
        if len(table):
            seg = _collect_segment(stages, i, table)
        if seg is not None:
            fused = _run_segment(seg, table, cache_host)
            if fused is not None:
                table = fused
                i = seg.end
                continue
            _log.info("fused segment at stage %d ran on the host "
                      "(entry coercion declined)", i)
        table = stages[i].transform(table)
        i += 1
    return table


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
