"""The training loop on one card: ``Trainer.fit_arrays``.

The port of ``mmlspark_tpu/train/loop.py`` for one device
(``TrainConfig``, ``make_optimizer``, ``make_loss``, the masked step of
``make_train_step``, ``_batches``, ``Trainer.fit_arrays``). One step is:
on-device preprocessing (:mod:`mmlspark_tpu_torch.train.preprocess`),
the forward, a per-example loss, the row-weighted mean
``(per·w).sum() / max(w.sum(), 1e-6)`` (zero-weight rows are the
zero-padded tail of an epoch and train as exact no-ops), the backward
and the optimizer update.

Per-token losses (logits ``[B, L, C]``, class axis last) reduce over ``L``
with the masked mean of ``_row_reduce``; for an integer ``[B, L]`` token
batch the step derives the ``token_mask`` from the module's
``pad_token_id``, as the JAX package's ``_token_mask`` does, so pad
positions count in neither the numerator nor the denominator of a row's
loss.

``TrainConfig.mesh_spec`` (or a ``mesh``) lays the step out on a mesh of
virtual ranks on the card (:mod:`mmlspark_tpu_torch.parallel.mesh`). The
module's ``mesh_hooks`` turn extra axes on with the same weights (a
``TransformerTagger`` runs ring attention over ``sp``), and an axis that
nothing uses raises, as in the JAX package. ``dp`` rounds the batch down
to a multiple of its size and changes no number; ``fsdp`` and ``tp``
above 1 are not ported and raise ``NotImplementedError``. No module of
the port uses ``pp`` or ``ep``, so they raise as unused axes.

``fit_arrays`` walks the same shuffled batches as the JAX package
(``_batches`` is numpy, copied verbatim), feeds them through a
prefetching :class:`~mmlspark_tpu_torch.train.input.DeviceLoader`, and
fetches each logged loss one step late, so the host waits on the device
at most once per log point while the next step is already queued; the
non-finite sentinel checks those fetched values.

Optimizers follow optax's definitions: ``sgd``, ``momentum``
(``optax.sgd(lr, momentum)``: ``torch.optim.SGD`` with dampening 0, not
Nesterov), ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root)
and ``adamw`` (decoupled decay ``lr·wd·p``).

Several hosts and cards, checkpoints and ``fit_stream`` are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.logging_utils import get_logger, timed
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.parallel import mesh as mesh_lib
from mmlspark_tpu_torch.train import preprocess as preprocess_lib
from mmlspark_tpu_torch.train.anomaly import NonFiniteSentinel
from mmlspark_tpu_torch.train.input import (
    DeviceLoader,
    HostToDevice,
    input_stats,
)

_log = get_logger(__name__)

OPTIMIZERS = ("adam", "adamw", "sgd", "momentum")
LOSSES = ("softmax_xent", "sigmoid_xent", "mse")


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 128
    epochs: int = 1
    learning_rate: float = 1e-3
    optimizer: str = "adam"          # adam | sgd | momentum | adamw
    weight_decay: float = 0.0        # adamw only, as in the JAX package
    momentum: float = 0.9
    loss: str = "softmax_xent"       # softmax_xent | sigmoid_xent | mse
    seed: int = 0
    log_every: int = 50
    # batches committed to the device ahead of the step (train/input.py);
    # 0 = assemble and upload inline. Numerics are the same at every depth
    prefetch_depth: int = 2
    # on-device scale applied after the float32 cast of uint8 inputs
    input_scale: float = 1.0 / 255.0
    # on-device preprocessing: a DevicePreprocess, its dict form, or None
    preprocess: Any = None
    # the non-finite loss sentinel (train/anomaly.py): raise | event | off
    nonfinite_loss: str = "raise"
    # where to train: None = cuda (raises without a card), or "cpu"
    device: Any = None
    # MeshSpec | dict | None: the axes of the mesh of virtual ranks on the
    # card (parallel/mesh.py); None = one rank
    mesh_spec: Any = None


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               dampening=0.0, nesterov=False)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}; one of "
                     f"{OPTIMIZERS}")


def _row_reduce(per: torch.Tensor, token_mask) -> torch.Tensor:
    """``[B, ...]`` per-position losses → ``[B]`` per-example.

    With a ``token_mask`` (``[B, L]``): the masked mean. The mask must
    match the loss grid's leading axes and broadcasts over any trailing
    (class) axes; a mask that tiles neither way raises, never a silent
    plain mean."""
    if token_mask is not None:
        if tuple(token_mask.shape) != tuple(per.shape[:token_mask.dim()]):
            raise ValueError(
                f"token_mask shape {tuple(token_mask.shape)} does not "
                f"tile per-position loss shape {tuple(per.shape)}")
        tm = token_mask.reshape(tuple(token_mask.shape)
                                + (1,) * (per.dim() - token_mask.dim()))
        tm = tm.expand(per.shape).to(per.dtype)
        per = (per * tm).reshape(per.shape[0], -1)
        tm = tm.reshape(per.shape)
        return per.sum(dim=1) / torch.clamp(tm.sum(dim=1), min=1.0)
    return per.reshape(per.shape[0], -1).mean(dim=1)


def make_loss(kind: str) -> Callable:
    """Per-example loss ``[B]``; the step takes its row-weighted mean.
    ``token_mask`` (``[B, L]`` 0/1, optional): per-token tasks reduce over
    ``L`` with a masked mean (see :func:`_row_reduce`)."""
    if kind == "softmax_xent":
        def loss(logits, labels, token_mask=None):
            # the class axis is the last one, as in optax's
            # softmax_cross_entropy_with_integer_labels
            z = logits.float()
            per = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                                  labels.long().reshape(-1),
                                  reduction="none").reshape(labels.shape)
            return _row_reduce(per, token_mask) if per.dim() > 1 else per
    elif kind == "sigmoid_xent":
        def loss(logits, labels, token_mask=None):
            z = logits.float()
            if z.dim() > labels.dim() and z.shape[-1] == 1:
                z = z.squeeze(-1)  # binary head [B, 1] vs labels [B]
            per = F.binary_cross_entropy_with_logits(
                z, labels.to(z.dtype), reduction="none")
            return _row_reduce(per, token_mask) if per.dim() > 1 else per
    elif kind == "mse":
        def loss(logits, labels, token_mask=None):
            pred = logits.float()
            if pred.dim() > labels.dim():
                pred = pred.squeeze(-1)
            per = (pred - labels.to(pred.dtype)) ** 2
            return _row_reduce(per, token_mask) if per.dim() > 1 else per
    else:
        raise ValueError(f"unknown loss {kind!r}; one of {LOSSES}")
    return loss


def resolve_mesh_hooks(module: Any, mesh: Any) -> dict:
    """Ask the module how it uses the mesh beyond dp: ``mesh_hooks(mesh)``
    returns ``apply_kwargs`` (extra forward kwargs that turn a parallel
    path on with the same weights, e.g. a ring ``attention_fn`` for
    ``sp``) and ``handled`` (the extra axes those kwargs use). Every
    virtual rank holds every parameter, so the JAX package's
    ``param_rules`` have nothing to place here."""
    hooks = {"apply_kwargs": {}, "handled": set()}
    if hasattr(module, "mesh_hooks"):
        got = module.mesh_hooks(mesh) or {}
        hooks["apply_kwargs"] = dict(got.get("apply_kwargs", {}))
        hooks["handled"] = set(got.get("handled", ()))
    return hooks


_EXTRA_AXES = ("sp", "pp", "ep")  # beyond the always-used dp/fsdp/tp
_NOT_PORTED_AXES = ("fsdp", "tp")  # pp and ep: check_mesh_axes_used


def check_mesh_axes_used(module: Any, mesh: Any, handled: set) -> None:
    """Refuse meshes with axes the training step would silently waste."""
    unused = [a for a in _EXTRA_AXES if mesh.shape.get(a, 1) > 1
              and a not in handled]
    if unused:
        raise ValueError(
            f"mesh axes {unused} have extent > 1 but "
            f"{type(module).__name__} does not use them — training would "
            "silently replicate all work over those devices. Use a module "
            "that implements mesh_hooks for these axes (TransformerTagger:"
            " sp via ring attention), or drop the axes from mesh_spec.")


def _check_mesh_ported(mesh: Any) -> None:
    big = [a for a in _NOT_PORTED_AXES if mesh.shape.get(a, 1) > 1]
    if big:
        raise NotImplementedError(
            f"mesh axes {big} > 1 are not ported: the port trains over dp "
            "and sp (ring attention) only")


def _batches(x: np.ndarray, y: np.ndarray, batch_size: int,
             seed: int, valid: np.ndarray | None = None) -> Iterator[tuple]:
    """Shuffled fixed-shape batches ``(bx, by, bw)``. The tail batch is
    zero-padded to ``batch_size`` with a 0/1 weight vector so no row is ever
    dropped (round-1/2 fix: ``drop_remainder`` silently lost up to
    ``batch_size-1`` rows per epoch) while XLA still sees one shape.

    ``valid`` (0/1 per row) marks rows that are themselves padding (the
    unequal-multi-host-shard case): they shuffle through the walk like any
    row but carry weight 0, so the batch count stays process-uniform while
    the padded rows train as exact no-ops."""
    n = len(x)
    order = np.random.default_rng(seed).permutation(n)
    weights = (np.ones(n, np.float32) if valid is None
               else np.asarray(valid, np.float32))
    for s in range(0, n, batch_size):
        idx = order[s:s + batch_size]
        if len(idx) == batch_size:
            yield x[idx], y[idx], weights[idx]
        else:
            pad = batch_size - len(idx)
            bx = np.concatenate([x[idx], np.zeros((pad,) + x.shape[1:],
                                                  x.dtype)])
            by = np.concatenate([y[idx], np.zeros((pad,) + y.shape[1:],
                                                  y.dtype)])
            bw = np.concatenate([weights[idx], np.zeros(pad, np.float32)])
            yield bx, by, bw


class Trainer:
    """Array-in trainer on one card.

    ``module`` is an ``nn.Module`` whose forward maps a batch (a float
    NHWC image batch after preprocessing, or an integer ``[B, L]`` token
    matrix) to logits; it is moved to ``cfg.device``.
    ``initial_state_dict`` (or :meth:`load_state_dict`) sets its weights
    before training, e.g. weights converted from the JAX package. ``mesh``
    (default: ``make_mesh(cfg.mesh_spec)`` on the trainer's device) lays
    the step out on virtual ranks; the module's ``mesh_hooks`` use its
    extra axes.

    After ``fit_arrays``: ``history`` holds the logged losses,
    ``global_step`` the steps taken, ``input_stats`` the input-wait
    accounting, and on CUDA ``step_ms`` each step's device time (CUDA
    events around the step's work on the compute stream)."""

    def __init__(self, module: torch.nn.Module,
                 cfg: TrainConfig | None = None,
                 initial_state_dict: dict | None = None, mesh: Any = None):
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(self.cfg.device)
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(
            self.cfg.mesh_spec, self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"mesh on {self.mesh.device}, trainer on "
                             f"{self.device}")
        hooks = resolve_mesh_hooks(module, self.mesh)
        check_mesh_axes_used(module, self.mesh, hooks["handled"])
        _check_mesh_ported(self.mesh)
        self.apply_kwargs = hooks["apply_kwargs"]
        self.module = module.to(self.device)
        self.preprocess = preprocess_lib.DevicePreprocess.parse(
            self.cfg.preprocess)
        self.loss_fn = make_loss(self.cfg.loss)
        # validated before any work, as the JAX package's make_train_step does
        NonFiniteSentinel("fit_arrays", self.cfg.nonfinite_loss)
        self.optimizer = make_optimizer(self.cfg, self.module.parameters())
        if initial_state_dict is not None:
            self.load_state_dict(initial_state_dict)
        self.global_step = 0
        self.history: list[float] = []
        self.input_stats: dict | None = None
        self.step_ms: list[float] | None = None

    def load_state_dict(self, state_dict: dict) -> "Trainer":
        self.module.load_state_dict(state_dict)
        return self

    def state_dict(self) -> dict:
        return self.module.state_dict()

    def _prep_x(self, x: torch.Tensor, step: int) -> torch.Tensor:
        # uint8 ships thin and casts on the device; with a DevicePreprocess
        # NHWC image batches replay geometry and augmentation in the step,
        # with draws from the generator of the global step
        cfg = self.cfg
        if self.preprocess is not None and x.dim() == 4:
            gen = preprocess_lib.step_generator(cfg.seed, step, x.device)
            return preprocess_lib.apply(self.preprocess, gen, x,
                                        cfg.input_scale)
        if x.dtype == torch.uint8:
            return x.to(torch.float32) * float(np.float32(cfg.input_scale))
        return x  # float batches and integer token matrices pass untouched

    def _token_mask(self, x: torch.Tensor) -> torch.Tensor | None:
        """``[B, L]`` 0/1 pad mask of an integer token batch, derived as the
        module derives its attention mask (``pad_token_id``)."""
        pad_id = getattr(self.module, "pad_token_id", None)
        if pad_id is not None and x.dim() == 2 \
                and not x.dtype.is_floating_point:
            return (x != pad_id).to(torch.float32)
        return None

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
        """One masked step on device tensors; returns the loss (a device
        scalar, not fetched)."""
        self.module.train()
        logits = self.module(self._prep_x(x, self.global_step),
                             **self.apply_kwargs)
        per = self.loss_fn(logits, y, token_mask=self._token_mask(x))
        loss = (per * w).sum() / torch.clamp(w.sum(), min=1e-6)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return loss.detach()

    def fit_arrays(self, x: np.ndarray, y: np.ndarray) -> "Trainer":
        """Train ``cfg.epochs`` epochs on host arrays ``x`` ``[N, ...]``
        and labels ``y`` ``[N, ...]``."""
        cfg = self.cfg
        if len(x) != len(y):
            raise ValueError(f"x has {len(x)} rows, y {len(y)}")
        # the batch divides over the data axis, as in the JAX package
        dp = self.mesh.shape["dp"]
        bs = min(cfg.batch_size, len(x)) // dp * dp
        if bs <= 0:
            raise ValueError(f"dataset of {len(x)} rows with batch_size "
                             f"{cfg.batch_size} on dp={dp}: nothing to "
                             "train")
        if self.preprocess is not None and x.ndim == 4:
            self.preprocess.out_shape(x.shape[1:])   # fail before any step
        h2d = HostToDevice(self.device)
        start = self.global_step

        def host_batches():
            gs = start
            for epoch in range(cfg.epochs):
                for i, batch in enumerate(
                        _batches(x, y, bs, cfg.seed + epoch)):
                    gs += 1
                    yield gs, i, batch

        def commit_batch(item):
            gs, i, batch = item
            return gs, i, h2d(batch)

        cuda = self.device.type == "cuda"
        events = []
        pending = None  # (global step, device loss scalar)
        sentinel = NonFiniteSentinel("fit_arrays", cfg.nonfinite_loss)
        loader = DeviceLoader(host_batches(), commit_batch,
                              depth=cfg.prefetch_depth, name="fit_arrays")
        t_loop = time.perf_counter()
        try:
            with timed(f"Trainer[{type(self.module).__name__}]", _log,
                       len(x)):
                for gs, i, transfer in loader:
                    dx, dy, dw = transfer.ready()
                    if cuda:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    loss = self.train_step(dx, dy, dw)
                    if cuda:
                        ev[1].record()
                        events.append(ev)
                    if i % cfg.log_every == 0:
                        if pending is not None:
                            self.history.append(sentinel.check(
                                pending[0], float(pending[1])))
                        pending = (gs, loss)
                if pending is not None:
                    self.history.append(sentinel.check(pending[0],
                                                       float(pending[1])))
        finally:
            loader.close()
        self.input_stats = input_stats(loader, time.perf_counter() - t_loop)
        if cuda:
            torch.cuda.synchronize(self.device)
            self.step_ms = [a.elapsed_time(b) for a, b in events]
        return self
