"""Batched image augmentation on the device, with the draws split from
the ops.

The port of ``mmlspark_tpu/ops/augment.py``: random crop after a reflect
pad, left-right and up-down flips, a per-sample brightness shift and a
per-sample contrast factor, composed in that fixed order, over NHWC float
batches (the path ``DevicePreprocess`` runs; the JAX package's integer
round-and-clip path is not ported).

The JAX ops draw inside each op from a ``jax.random`` key. Here drawing
and applying are two steps: :func:`draw` makes every per-sample draw of a
batch from one ``torch.Generator`` on the batch's device, and
:func:`apply` is deterministic given them. ``jax.random`` and
``torch.Generator`` give other numbers from one seed, so the tests hand
the same draws to :func:`apply` and to the JAX package's numpy oracles
(``host_crop``, ``host_brightness``, ``host_contrast``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Draws:
    """One batch's per-sample draws; ``None`` for a stage that is off.

    ``crop_oy``/``crop_ox`` are int64 offsets into the padded image in
    ``[0, 2·pad]``; ``flip_lr``/``flip_ud`` bool coins; ``brightness`` the
    float32 shift; ``contrast`` the float32 factor. Each is ``[N]``."""

    crop_oy: torch.Tensor | None = None
    crop_ox: torch.Tensor | None = None
    flip_lr: torch.Tensor | None = None
    flip_ud: torch.Tensor | None = None
    brightness: torch.Tensor | None = None
    contrast: torch.Tensor | None = None


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def draw(gen: torch.Generator, n: int, spec: Any,
         device: Any = None) -> Draws:
    """Every draw of one batch of ``n`` samples for the stages ``spec``
    turns on (its ``crop_pad``, ``flip_lr``, ``flip_ud``, ``brightness``
    and ``contrast`` fields, as on ``DevicePreprocess``), from ``gen`` on
    ``device`` (default: the generator's)."""
    device = gen.device if device is None else device
    d = Draws()
    if spec.crop_pad:
        hi = 2 * spec.crop_pad + 1
        d.crop_oy = torch.randint(0, hi, (n,), generator=gen, device=device)
        d.crop_ox = torch.randint(0, hi, (n,), generator=gen, device=device)
    if spec.flip_lr:
        d.flip_lr = torch.rand(n, generator=gen, device=device) < 0.5
    if spec.flip_ud:
        d.flip_ud = torch.rand(n, generator=gen, device=device) < 0.5
    if spec.brightness:
        b = float(spec.brightness)
        d.brightness = _uniform(gen, n, -b, b, device)
    if spec.contrast is not None:
        lo, hi = spec.contrast
        d.contrast = _uniform(gen, n, float(lo), float(hi), device)
    return d


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def random_crop(batch: torch.Tensor, pad: int, oy: torch.Tensor,
                ox: torch.Tensor) -> torch.Tensor:
    """Reflect-pad ``pad`` on each spatial side, take the original H×W
    window at ``(oy[i], ox[i])`` of the padded sample ``i``."""
    n, h, w, _ = batch.shape
    padded = F.pad(batch.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="reflect").permute(0, 2, 3, 1)
    rows = oy.to(torch.int64)[:, None] + torch.arange(h, device=batch.device)
    cols = ox.to(torch.int64)[:, None] + torch.arange(w, device=batch.device)
    idx = torch.arange(n, device=batch.device)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def flip_lr(batch: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """Flip sample ``i`` left-right where ``coin[i]``."""
    return torch.where(_per_sample(coin), batch.flip(2), batch)


def flip_ud(batch: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """Flip sample ``i`` up-down where ``coin[i]``."""
    return torch.where(_per_sample(coin), batch.flip(1), batch)


def brightness(batch: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Add ``shift[i]`` to every value of sample ``i``."""
    return batch + _per_sample(shift).to(batch.dtype)


def contrast(batch: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Scale each sample's deviation from its own mean by ``factor[i]``."""
    mean = batch.mean(dim=(1, 2, 3), keepdim=True)
    return mean + (batch - mean) * _per_sample(factor).to(batch.dtype)


def apply(batch: torch.Tensor, draws: Draws, crop_pad: int = 0
          ) -> torch.Tensor:
    """Run the drawn stages over a float NHWC batch in the JAX package's
    order: crop, left-right flip, up-down flip, brightness, contrast."""
    if not batch.is_floating_point():
        raise TypeError(f"augment.apply takes float batches, got "
                        f"{batch.dtype}")
    if draws.crop_oy is not None:
        batch = random_crop(batch, crop_pad, draws.crop_oy, draws.crop_ox)
    if draws.flip_lr is not None:
        batch = flip_lr(batch, draws.flip_lr)
    if draws.flip_ud is not None:
        batch = flip_ud(batch, draws.flip_ud)
    if draws.brightness is not None:
        batch = brightness(batch, draws.brightness)
    if draws.contrast is not None:
        batch = contrast(batch, draws.contrast)
    return batch
