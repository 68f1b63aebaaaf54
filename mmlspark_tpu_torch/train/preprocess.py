"""On-device train preprocessing: the :class:`DevicePreprocess` spec the
train step runs before the forward.

The port of ``mmlspark_tpu/train/preprocess.py``. The loader ships
source-resolution uint8 batches; the step replays, on the device:

1. **geometry**: a random source crop (``src_crop``) and a bilinear
   ``resize``, fused with the float32 ``× input_scale`` cast in one pass
   (:func:`mmlspark_tpu_torch.ops.resize.fused_resize_norm`: the CUDA
   kernel for CUDA tensors, chosen by ``impl``);
2. **stochastic augment**: pad and random crop, flips, brightness,
   contrast (:mod:`mmlspark_tpu_torch.ops.augment`, on normalised floats);
3. **standardize**: optional per-channel ``(x − mean) / std``.

With no crop and no resize the geometry is the identity, and stage 1 is
the plain cast (no kernel), as in the JAX package.

Float input is taken as already preprocessed through stage 1, so only
stages 2–3 run on it. Every draw comes from a ``torch.Generator`` on the
batch's device seeded from ``(seed, global step)`` (:func:`step_generator`),
so a run replays its own augmentation stream whatever its prefetch depth.
The output carries no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.ops import augment
from mmlspark_tpu_torch.ops.resize import fused_resize_norm

IMPLS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class DevicePreprocess:
    """Declarative on-device preprocessing spec, run in the train step by
    ``TrainConfig(preprocess=...)``.

    Geometry fields (``src_crop``, ``resize``) consume the uint8 wire form;
    stochastic fields are in the NORMALISED scale (``brightness=0.1``
    shifts [0, 1]-scaled pixels); ``mean``/``std`` standardise per channel
    after augmentation. ``impl`` chooses the geometry pass: ``auto`` (the
    kernel for CUDA tensors, the plain version for CPU tensors), ``cuda``
    or ``torch``."""

    resize: tuple | None = None      # (oh, ow) bilinear target
    src_crop: tuple | None = None    # (ch, cw) random source window
    crop_pad: int = 0                # post-resize reflect pad + random crop
    flip_lr: bool = False
    flip_ud: bool = False
    brightness: float = 0.0          # uniform shift in [-b, b], normalised
    contrast: tuple | None = None    # (lo, hi) per-sample contrast factor
    mean: tuple | None = None        # per-channel, normalised scale
    std: tuple | None = None
    impl: str = "auto"               # auto | cuda | torch

    def __post_init__(self):
        for field in ("resize", "src_crop", "contrast", "mean", "std"):
            v = getattr(self, field)
            if v is not None:
                object.__setattr__(self, field, tuple(v))
        for field in ("resize", "src_crop"):
            v = getattr(self, field)
            if v is not None and (len(v) != 2 or min(v) < 1):
                raise ValueError(f"DevicePreprocess.{field} must be a "
                                 f"(height, width) pair >= 1, got {v!r}")
        if self.contrast is not None and (
                len(self.contrast) != 2
                or not 0 <= self.contrast[0] <= self.contrast[1]):
            raise ValueError("DevicePreprocess.contrast must be a "
                             f"0 <= lo <= hi pair, got {self.contrast!r}")
        if self.crop_pad < 0:
            raise ValueError(
                f"DevicePreprocess.crop_pad must be >= 0, "
                f"got {self.crop_pad}")
        if self.std is not None and any(s == 0 for s in self.std):
            raise ValueError("DevicePreprocess.std contains a zero "
                             f"channel: {self.std!r}")
        if self.impl not in IMPLS:
            raise ValueError(f"DevicePreprocess.impl must be one of "
                             f"{IMPLS}, got {self.impl!r}")

    @classmethod
    def parse(cls, obj: Any) -> "DevicePreprocess | None":
        """None / spec / plain-dict (the TrainConfig wire form) → spec."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(
            "TrainConfig.preprocess must be a DevicePreprocess, a dict of "
            f"its fields, or None; got {type(obj).__name__}")

    def out_shape(self, in_shape: tuple) -> tuple:
        """Replay the spec over an ``(h, w, c)`` input geometry; raises
        ``ValueError`` on a geometry the chain would reject."""
        if len(in_shape) != 3:
            raise ValueError(
                f"DevicePreprocess expects (h, w, c) image geometry, "
                f"got {tuple(in_shape)}")
        h, w, c = (int(d) for d in in_shape)
        if self.src_crop is not None:
            ch, cw = self.src_crop
            if ch > h or cw > w:
                raise ValueError(
                    f"src_crop {self.src_crop} larger than the source "
                    f"image ({h}, {w})")
            h, w = ch, cw
        if self.resize is not None:
            h, w = self.resize
        if self.crop_pad and self.crop_pad > min(h, w) - 1:
            raise ValueError(
                f"crop_pad {self.crop_pad} needs reflect padding wider "
                f"than the {h}x{w} image allows (max {min(h, w) - 1})")
        for field in ("mean", "std"):
            v = getattr(self, field)
            if v is not None and len(v) not in (1, c):
                raise ValueError(
                    f"{field} has {len(v)} channels for {c}-channel "
                    "images")
        return h, w, c


def step_generator(seed: int, step: int, device: Any) -> torch.Generator:
    """The generator of global step ``step``: seeded from ``(seed, step)``
    through numpy's ``SeedSequence``, so nearby seeds and steps give
    unrelated streams."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 32 | int(state[1])) >> 1)
    return gen


def geometry_draws(gen: torch.Generator, spec: DevicePreprocess,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-sample source window offsets of a batch: uniform in
    ``[0, H − ch] × [0, W − cw]`` with ``src_crop``, else zeros."""
    n, h, w, _ = x.shape
    if spec.src_crop is None:
        zeros = torch.zeros(n, dtype=torch.int32, device=x.device)
        return zeros, zeros
    ch, cw = spec.src_crop
    oy = torch.randint(0, h - ch + 1, (n,), generator=gen, device=x.device,
                       dtype=torch.int32)
    ox = torch.randint(0, w - cw + 1, (n,), generator=gen, device=x.device,
                       dtype=torch.int32)
    return oy, ox


def geometry_normalize(spec: DevicePreprocess, x: torch.Tensor,
                       oy: torch.Tensor, ox: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Stage 1 on the uint8 wire form: source crop + bilinear resize +
    float32 × scale in one pass, or the plain cast for identity geometry."""
    _, h, w, _ = x.shape
    ch, cw = spec.src_crop or (h, w)
    out_hw = spec.resize or (ch, cw)
    if spec.src_crop is None and tuple(out_hw) == (h, w):
        # identity geometry: v00 × 1 = v00, so the fused pass is the cast
        return x.to(torch.float32) * float(np.float32(scale))
    return fused_resize_norm(x, oy, ox, (ch, cw), out_hw, scale,
                             impl=spec.impl)


def apply(spec: DevicePreprocess, gen: torch.Generator, x: torch.Tensor,
          scale: float) -> torch.Tensor:
    """The in-step entry: the full chain for uint8 input, stages 2–3 for
    float input. Draws come from ``gen``: the geometry's first, then the
    augmentation's."""
    with torch.no_grad():
        if x.dtype == torch.uint8:
            oy, ox = geometry_draws(gen, spec, x)
            x = geometry_normalize(spec, x, oy, ox, scale)
        else:
            x = x.to(torch.float32)
        draws = augment.draw(gen, x.shape[0], spec, x.device)
        x = augment.apply(x, draws, spec.crop_pad)
        if spec.mean is not None:
            x = x - torch.tensor(spec.mean, dtype=torch.float32,
                                 device=x.device)
        if spec.std is not None:
            x = x / torch.tensor(spec.std, dtype=torch.float32,
                                 device=x.device)
    # the batch is data, not a differentiation target
    return x.detach()
