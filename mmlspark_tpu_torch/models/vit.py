"""ViT — vision transformer with a GAP head; the defaults are B/16.

The port of ``mmlspark_tpu/models/vit.py`` (``BhtdSelfAttention``,
``EncoderBlock``, ``ViT``, ``vit_b16``, ``vit_tiny``): 16×16 patch
embedding as a strided conv, pre-LN encoder blocks (MHSA + MLP), a
global-average-pool head, ``features`` (the pooled final-LN embedding)
and ``logits`` output nodes. Input is NHWC, as in the JAX package.

Numerics follow flax, not PyTorch's defaults, so converted weights give
the same outputs (``models/convert.py``):

* parameters are float32 masters; each layer casts its input and its
  weights to the compute ``dtype`` at every call (flax's ``dtype``), so
  bfloat16 compute never depends on autocast;
* LayerNorm uses ``eps=1e-6`` and one-pass float32 statistics,
  ``var = max(E[x²] − E[x]², 0)``, then casts to the compute dtype;
* GELU is the tanh approximation (``flax.linen.gelu``'s default);
* patches flatten in (h, w) row order, matching the JAX
  ``x.reshape(B, h*w, dim)`` of the NHWC conv output;
* ``features``/``logits`` are cast to float32.

Attention ``attn_impl``: ``"einsum"`` (scores, softmax, weighted sum; the
JAX ``"bhtd"`` path), ``"flash"`` (:func:`flash_attention` with
``impl="auto"``: the CUDA kernel on the card) or ``"flash_torch"`` (the
same recurrence through its plain PyTorch version, the JAX
``"flash_xla"``). The pipelined ``pp`` path and ``remat`` are not part of
this port yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.ops.attention import flash_attention

# flax's truncated-normal stddev correction for a [-2, 2] sigma cut
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """``Linear`` with flax ``Dense`` semantics: float32 weight ``[out, in]``
    and bias, cast with the input to ``dtype`` at each call."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: float32 one-pass statistics clipped at 0,
    ``eps=1e-6``, output cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        self.compute_dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class BhtdSelfAttention(nn.Module):
    """Self-attention computed in ``[B, H, T, dh]`` layout.

    ``query``/``key``/``value`` project ``D → H·dh`` (the flax
    ``DenseGeneral`` kernels ``[D, H, dh]`` flattened), ``out`` projects
    ``H·dh → D``."""

    IMPLS = ("einsum", "flash", "flash_torch")

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 impl: str = "flash", device=None):
        super().__init__()
        if impl not in self.IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; one of "
                             f"{list(self.IMPLS)}")
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.heads = heads
        self.impl = impl
        self.compute_dtype = dtype
        self.query = Dense(dim, dim, dtype, device)
        self.key = Dense(dim, dim, dtype, device)
        self.value = Dense(dim, dim, dtype, device)
        self.out = Dense(dim, dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        dh = d // h
        # [B, T, H, dh] viewed as [B, H, T, dh]: no copy (the kernel takes
        # strides)
        q = self.query(x).view(b, t, h, dh).transpose(1, 2)
        k = self.key(x).view(b, t, h, dh).transpose(1, 2)
        v = self.value(x).view(b, t, h, dh).transpose(1, 2)
        if self.impl == "einsum":
            q = q * dh ** -0.5
            probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
            o = torch.matmul(probs, v)
        else:
            kernel_impl = "auto" if self.impl == "flash" else "torch"
            o = flash_attention(q, k, v, impl=kernel_impl)
            o = o.to(self.compute_dtype)
        return self.out(o.transpose(1, 2).reshape(b, t, d))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype, attn_impl: str = "flash", device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype, device)
        self.attn = BhtdSelfAttention(dim, heads, dtype, attn_impl, device)
        self.ln2 = LayerNorm(dim, dtype, device)
        self.mlp_in = Dense(dim, mlp_dim, dtype, device)
        self.mlp_out = Dense(mlp_dim, dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class ViT(nn.Module):
    """Vision transformer with GAP head over NHWC ``[B, S, S, 3]`` input of
    side ``image_size``; defaults are B/16 at 224². Built on ``device``
    (None = cuda, which raises without a card; ``"cpu"`` when asked)."""

    OUTPUT_NAMES = ("features", "logits")

    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "flash", device=None):
        super().__init__()
        device = resolve_device(device)
        if image_size % patch:
            raise ValueError(
                f"input {image_size}x{image_size} not divisible by patch "
                f"{patch}")
        self.patch = patch
        self.image_size = image_size
        self.compute_dtype = dtype
        # the flax conv's SAME padding is 0 here: stride == kernel and the
        # side divides by the patch, so a padding-free conv is exact
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch,
                                     device=device)
        grid = image_size // patch
        self.pos_embed = nn.Parameter(
            torch.empty(grid * grid, dim, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, mlp_dim, dtype, attn_impl, device)
            for _ in range(depth))
        self.ln_f = LayerNorm(dim, dtype, device)
        self.head = Dense(dim, num_classes, dtype, device)

    def embed_patches(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, S, S, 3]`` → patch tokens ``[B, h*w, dim]`` in the
        compute dtype, in (h, w) row order."""
        dt = self.compute_dtype
        conv = self.patch_embed
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt),
                     conv.bias.to(dt), stride=self.patch)
        return x.flatten(2).transpose(1, 2)

    def forward(self, x: torch.Tensor, output: str = "logits"
                ) -> torch.Tensor:
        if output not in self.OUTPUT_NAMES:
            raise ValueError(f"unknown output node {output!r}; available: "
                             f"{self.OUTPUT_NAMES}")
        b, hh, ww, _ = x.shape
        if hh != self.image_size or ww != self.image_size:
            raise ValueError(f"input {hh}x{ww}; this ViT takes "
                             f"{self.image_size}x{self.image_size}")
        x = self.embed_patches(x)
        x = x + self.pos_embed[None].to(self.compute_dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x).mean(dim=1)                  # GAP over patches
        if output == "features":
            return x.float()
        return self.head(x).float()


def vit_b16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
            **kw) -> ViT:
    return ViT(num_classes=num_classes, dtype=dtype, **kw)


def vit_tiny(num_classes: int = 10, image_patch: int = 8,
             dtype: torch.dtype = torch.float32, image_size: int = 32,
             **kw) -> ViT:
    """Small same-class config for tests."""
    return ViT(num_classes=num_classes, image_size=image_size,
               patch=image_patch, dim=64, depth=2, heads=4, mlp_dim=128,
               dtype=dtype, **kw)


@torch.no_grad()
def init_vit_(model: ViT, generator: torch.Generator) -> ViT:
    """Fill every parameter from ``generator`` with flax's initializers:
    truncated LeCun-normal kernels (stddev ``sqrt(1/fan_in)``, cut at two
    sigma), zero biases, unit LayerNorm scales, ``N(0, 0.02)``
    ``pos_embed``. The numbers differ from flax's for the same seed
    (another generator); parity tests convert the JAX weights instead."""
    for mod in model.modules():
        if isinstance(mod, (Dense, nn.Conv2d)):
            w = mod.weight
            fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
