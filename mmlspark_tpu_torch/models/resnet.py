"""ResNet v1.5 with bottleneck blocks and GroupNorm; stages (3, 4, 6, 3)
are ResNet-50.

The port of ``mmlspark_tpu/models/resnet.py`` for ``norm="group"`` (the
training variant): ``BottleneckBlock`` (1×1 → 3×3 with the stride → 1×1,
projection shortcut), ``ResNet`` (7×7/2 stem, 3×3/2 max-pool, stages,
global average pool, dense head), ``resnet50`` and ``resnet18_thin``.
Input and activations are NHWC, as in the JAX package: each activation is
a contiguous ``[N, H, W, C]`` tensor, and a conv sees it as an NCHW
tensor in ``torch.channels_last`` (the same memory), so the GroupNorm
kernel reads the conv's output without a copy.

Numerics follow flax, so converted weights give the same outputs
(``models/convert.py``):

* parameters are float32 masters; convs, the head and the pooling run in
  the compute ``dtype``, with inputs and weights cast at every call;
* ``SAME`` padding is flax's rule, which is asymmetric for stride 2 on
  even inputs (the 7×7/2 stem pads (2, 3), the 3×3/2 convs (0, 1), the
  max-pool (0, 1) with −inf): pads are worked out from the input size at
  each call and applied explicitly where they are uneven;
* GroupNorm uses ``eps`` 1e-6 and ``min(groups, C)`` groups at every site,
  ReLU fused after gn1, gn2 and the stem's GN, none after gn3 or gn_proj;
  its output is cast to the compute dtype;
* the projection shortcut is taken whenever the residual's shape differs
  from the block's output (stage 0, block 0 included: 64 → 256 channels);
* ``features`` (the pooled embedding) and ``logits`` come out float32.

``gn_impl`` chooses the GroupNorm route: ``auto`` (the CUDA kernel for
CUDA tensors, the plain version for CPU tensors), ``cuda`` or ``torch``.
``norm="batch"``/``"none"``, ``fold_batchnorm`` and the space-to-depth
stem are not ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.ops.group_norm import IMPLS as GN_IMPLS
from mmlspark_tpu_torch.ops.group_norm import group_norm

# flax's truncated-normal stddev correction for a [-2, 2] sigma cut
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, ph: tuple, pw: tuple,
              value: float = 0.0) -> torch.Tensor:
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv`` over NHWC input with ``SAME`` padding: float32
    weight ``[out, in, k, k]`` (and, with ``bias=True``, a float32 bias
    ``[out]`` fused into the conv), cast with the input to ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype, device=None, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)
        self.k, self.stride, self.compute_dtype = k, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        ph = same_pads(x.shape[1], self.k, self.stride)
        pw = same_pads(x.shape[2], self.k, self.stride)
        x = x.to(dt)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = _pad_nhwc(x, ph, pw)
            padding = (0, 0)
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.stride,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """One GroupNorm(+ReLU) site: float32 ``scale``/``bias`` of ``[C]``
    (flax's names), :func:`group_norm` with ``eps`` 1e-6, output cast to
    the compute dtype."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype,
                 impl: str = "auto", device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.groups, self.compute_dtype, self.impl = groups, dtype, impl

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        y = group_norm(x, self.scale, self.bias, self.groups, relu=relu,
                       impl=self.impl)
        return y.to(self.compute_dtype)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck with projection shortcut (ResNet v1.5:
    the stride lives on the 3×3)."""

    def __init__(self, cin: int, filters: int, stride: int, groups: int,
                 dtype: torch.dtype, gn_impl: str, device=None):
        super().__init__()
        g = groups
        self.conv1 = Conv(cin, filters, 1, 1, dtype, device)
        self.gn1 = GroupNorm(filters, min(g, filters), dtype, gn_impl, device)
        self.conv2 = Conv(filters, filters, 3, stride, dtype, device)
        self.gn2 = GroupNorm(filters, min(g, filters), dtype, gn_impl, device)
        self.conv3 = Conv(filters, 4 * filters, 1, 1, dtype, device)
        self.gn3 = GroupNorm(4 * filters, min(g, 4 * filters), dtype,
                             gn_impl, device)
        self.stride = stride
        # the JAX block takes the projection when residual.shape != y.shape
        # (known from the widths and the stride alone)
        if cin != 4 * filters or stride != 1:
            self.proj = Conv(cin, 4 * filters, 1, stride, dtype, device)
            self.gn_proj = GroupNorm(4 * filters, min(g, 4 * filters), dtype,
                                     gn_impl, device)
        else:
            self.proj = self.gn_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gn1(self.conv1(x), relu=True)
        y = self.gn2(self.conv2(y), relu=True)
        y = self.gn3(self.conv3(y))
        residual = x
        if self.proj is not None:
            residual = self.gn_proj(self.proj(x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC ``[B, H, W, 3]`` input of any size; built on
    ``device`` (None = cuda, which raises without a card; ``"cpu"`` when
    asked). The conv weights are left unset: :func:`init_resnet_` (as the
    zoo does) or ``load_state_dict`` fills them."""

    OUTPUT_NAMES = ("features", "logits")

    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 groups: int = 32, dtype: torch.dtype = torch.bfloat16,
                 gn_impl: str = "auto", device=None):
        super().__init__()
        if gn_impl not in GN_IMPLS:
            raise ValueError(f"unknown gn_impl {gn_impl!r}; one of "
                             f"{list(GN_IMPLS)}")
        device = resolve_device(device)
        self.compute_dtype = dtype
        self.conv_stem = Conv(3, width, 7, 2, dtype, device)
        self.gn_stem = GroupNorm(width, min(groups, width), dtype, gn_impl,
                                 device)
        self.blocks = nn.ModuleDict()
        cin = width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                self.blocks[f"stage{stage}_block{block}"] = BottleneckBlock(
                    cin, filters, stride, min(groups, filters), dtype,
                    gn_impl, device)
                cin = 4 * filters
        self.head = nn.Linear(cin, num_classes, device=device)

    def forward(self, x: torch.Tensor, output: str = "logits"
                ) -> torch.Tensor:
        if output not in self.OUTPUT_NAMES:
            raise ValueError(f"unknown output node {output!r}; available: "
                             f"{self.OUTPUT_NAMES}")
        dt = self.compute_dtype
        x = self.gn_stem(self.conv_stem(x.to(dt)), relu=True)
        # 3×3/2 max-pool with flax SAME padding (-inf pads)
        ph = same_pads(x.shape[1], 3, 2)
        pw = same_pads(x.shape[2], 3, 2)
        x = _pad_nhwc(x, ph, pw, value=float("-inf"))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        for block in self.blocks.values():
            x = block(x)
        x = x.mean(dim=(1, 2))               # GAP in the compute dtype
        if output == "features":
            return x.float()
        return F.linear(x, self.head.weight.to(dt),
                        self.head.bias.to(dt)).float()


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             gn_impl: str = "auto", **kw) -> ResNet:
    return ResNet(num_classes=num_classes, stage_sizes=(3, 4, 6, 3),
                  dtype=dtype, gn_impl=gn_impl, **kw)


def resnet18_thin(num_classes: int = 10, width: int = 16,
                  dtype: torch.dtype = torch.bfloat16, gn_impl: str = "auto",
                  **kw) -> ResNet:
    """Small same-family net for tests (bottleneck (2, 2) stages, 8
    groups)."""
    return ResNet(num_classes=num_classes, stage_sizes=(2, 2), width=width,
                  groups=8, dtype=dtype, gn_impl=gn_impl, **kw)


def gn_sites(model: ResNet) -> int:
    """GroupNorm sites one forward runs (53 for ResNet-50)."""
    return sum(1 for m in model.modules() if isinstance(m, GroupNorm))


@torch.no_grad()
def init_resnet_(model: ResNet, generator: torch.Generator) -> ResNet:
    """Fill every parameter from ``generator`` with flax's initializers:
    truncated LeCun-normal conv and head kernels (stddev
    ``sqrt(1/fan_in)``, cut at two sigma), zero head bias, unit GroupNorm
    scales and zero biases. The numbers differ from flax's for the same
    seed (another generator); parity tests convert the JAX weights."""
    for mod in model.modules():
        if isinstance(mod, (Conv, nn.Linear)):
            w = mod.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        if isinstance(mod, nn.Linear):
            mod.bias.zero_()
        elif isinstance(mod, GroupNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
    return model
