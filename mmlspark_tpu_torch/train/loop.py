"""The single-device training loop: ``Trainer.fit_arrays``.

The port of ``mmlspark_tpu/train/loop.py`` for one device
(``TrainConfig``, ``make_optimizer``, ``make_loss``, the masked step of
``make_train_step``, ``_batches``, ``Trainer.fit_arrays``). One step is:
on-device preprocessing (:mod:`mmlspark_tpu_torch.train.preprocess`),
the forward, a per-example loss, the row-weighted mean
``(per·w).sum() / max(w.sum(), 1e-6)`` (zero-weight rows are the
zero-padded tail of an epoch and train as exact no-ops), the backward
and the optimizer update.

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

Meshes, several hosts, checkpoints and ``fit_stream`` are not ported.
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


def _per_example(per: torch.Tensor) -> torch.Tensor:
    # multi-output heads: one loss per example, the mean over the rest
    return per.reshape(per.shape[0], -1).mean(dim=1) if per.dim() > 1 \
        else per


def make_loss(kind: str) -> Callable:
    """Per-example loss ``[B]``; the step takes its row-weighted mean."""
    if kind == "softmax_xent":
        def loss(logits, labels):
            return _per_example(F.cross_entropy(
                logits.float(), labels.long(), reduction="none"))
    elif kind == "sigmoid_xent":
        def loss(logits, labels):
            z = logits.float()
            if z.dim() > labels.dim() and z.shape[-1] == 1:
                z = z.squeeze(-1)  # binary head [B, 1] vs labels [B]
            return _per_example(F.binary_cross_entropy_with_logits(
                z, labels.to(z.dtype), reduction="none"))
    elif kind == "mse":
        def loss(logits, labels):
            pred = logits.float()
            if pred.dim() > labels.dim():
                pred = pred.squeeze(-1)
            return _per_example((pred - labels.to(pred.dtype)) ** 2)
    else:
        raise ValueError(f"unknown loss {kind!r}; one of {LOSSES}")
    return loss


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
    """Array-in trainer on one device.

    ``module`` is an ``nn.Module`` whose forward maps a float NHWC batch
    (after preprocessing) to logits; it is moved to ``cfg.device``.
    ``initial_state_dict`` (or :meth:`load_state_dict`) sets its weights
    before training, e.g. weights converted from the JAX package.

    After ``fit_arrays``: ``history`` holds the logged losses,
    ``global_step`` the steps taken, ``input_stats`` the input-wait
    accounting, and on CUDA ``step_ms`` each step's device time (CUDA
    events around the step's work on the compute stream)."""

    def __init__(self, module: torch.nn.Module,
                 cfg: TrainConfig | None = None,
                 initial_state_dict: dict | None = None):
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(self.cfg.device)
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
        return x

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
        """One masked step on device tensors; returns the loss (a device
        scalar, not fetched)."""
        self.module.train()
        logits = self.module(self._prep_x(x, self.global_step))
        per = self.loss_fn(logits, y)
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
        bs = min(cfg.batch_size, len(x))
        if bs <= 0:
            raise ValueError(f"dataset of {len(x)} rows with batch_size "
                             f"{cfg.batch_size}: nothing to train")
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
