"""The CIFAR-10 ConvNet: three blocks of two 3×3 convs and a 2×2 max-pool,
then a dense layer and a dense head.

The port of ``ConvNetCifar`` of ``mmlspark_tpu/models/zoo.py``. Input and
activations are NHWC, as in the JAX package: each activation is a
contiguous ``[N, H, W, C]`` tensor, and a conv or the pooling sees it as
an NCHW tensor in ``torch.channels_last`` (the same memory). The layers
are the ResNet's :class:`~mmlspark_tpu_torch.models.resnet.Conv` (with its
bias) and the ViT's :class:`~mmlspark_tpu_torch.models.vit.Dense`.

Numerics follow flax, so converted weights give the same outputs
(``models/convert.py``):

* parameters are float32 masters, cast with the input to the compute
  ``dtype`` at every call (no autocast);
* each conv and dense layer adds its bias inside the product, as the
  ViT's layers do: flax rounds the product to ``dtype`` first and then
  adds the bias, so in bfloat16 the two differ by bf16 steps
  (``tests/test_torch_convnet.py`` pins the gap); in float32 they agree;
* the ReLU is ``F.relu``, whose gradient at 0 is 0, as ``nn.relu``'s is;
* the 2×2 max-pool (stride 2, no padding) sends a tied window's gradient
  to its first maximum in row-major order, as ``jax.vjp`` of
  ``nn.max_pool`` does;
* the flatten before ``dense0`` is in (h, w, C) order, flax's order over
  NHWC: ``dense0``'s converted weight expects exactly that;
* ``features`` (the ReLU of ``dense0``) and ``logits`` come out float32.

The JAX module's ``stem="patch"`` (``PatchConv3x3``, a space-to-depth
matmul shaped for the TPU's MXU) computes the same 3×3 conv with the same
parameters, so a patch-stem checkpoint converts to this module as it is.
The convs, GEMMs and pooling are PyTorch ops: the JAX package leaves them
to XLA, so no hand kernel stands behind them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.resnet import _TRUNC_STD, Conv
from mmlspark_tpu_torch.models.vit import Dense


class ConvNetCifar(nn.Module):
    """The CIFAR-10 ConvNet over NHWC ``[B, 32, 32, 3]`` input (the
    size fixes ``dense0``'s width, which flax infers at its first call);
    built on ``device`` (None = cuda, which raises without a card;
    ``"cpu"`` when asked). The kernels are left unset:
    :func:`init_convnet_` (as the zoo does) or ``load_state_dict`` fills
    them."""

    OUTPUT_NAMES = ("features", "logits")
    INPUT_SPEC = (32, 32, 3)

    def __init__(self, num_classes: int = 10,
                 widths: Sequence[int] = (128, 256, 512),
                 dense_width: int = 512, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.widths = num_classes, tuple(widths)
        self.dense_width, self.compute_dtype = dense_width, dtype
        h, w, cin = self.INPUT_SPEC
        # flax's names: conv{i}a, conv{i}b, dense0, head
        for i, width in enumerate(self.widths):
            self.add_module(f"conv{i}a",
                            Conv(cin, width, 3, 1, dtype, device, bias=True))
            self.add_module(f"conv{i}b",
                            Conv(width, width, 3, 1, dtype, device, bias=True))
            cin, h, w = width, h // 2, w // 2
        self.dense0 = Dense(h * w * cin, dense_width, dtype, device)
        self.head = Dense(dense_width, num_classes, dtype, device)

    def forward(self, x: torch.Tensor, output: str = "logits"
                ) -> torch.Tensor:
        if output not in self.OUTPUT_NAMES:
            raise ValueError(f"unknown output node {output!r}; available: "
                             f"{self.OUTPUT_NAMES}")
        x = x.to(self.compute_dtype)
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"conv{i}a")(x))
            x = F.relu(getattr(self, f"conv{i}b")(x))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        # flatten in (h, w, C) order, as flax reshapes NHWC
        x = F.relu(self.dense0(x.reshape(x.shape[0], -1)))
        if output == "features":
            return x.float()
        return self.head(x).float()


@torch.no_grad()
def init_convnet_(model: ConvNetCifar, generator: torch.Generator
                  ) -> ConvNetCifar:
    """Fill every parameter from ``generator`` with flax's initializers:
    truncated LeCun-normal kernels (stddev ``sqrt(1/fan_in)``, cut at two
    sigma) and zero biases. The numbers differ from flax's for the same
    seed (another generator); parity tests convert the JAX weights."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
    return model
