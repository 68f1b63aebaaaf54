"""TransformerTagger — the causal Transformer of the generation path.

The port of ``mmlspark_tpu/models/sequence.py:TransformerTagger`` on its
single-device path: token and learned position embeddings, pre-LN blocks
(fused ``qkv`` projection, attention, ``proj``; LayerNorm, a GELU MLP), a
final LayerNorm and an untied ``head`` with a bias. Numerics follow flax
as in :mod:`mmlspark_tpu_torch.models.vit` (LayerNorm eps 1e-6 with
one-pass float32 statistics, tanh GELU), and the model computes in float32,
as the JAX module does (none of its ``Dense`` layers take a ``dtype``).

Two entry points share the weights:

* :meth:`TransformerTagger.forward` — the full forward over ``[B, L]``
  tokens with a ``[B, L]`` pad mask; attention is the plain masked softmax
  of ``parallel/ring_attention.attention_reference`` (plain XLA in the JAX
  package, plain PyTorch here). ``return_cache=True`` also returns every
  layer's K/V stacked ``[B, layers, H, L, head_dim]``: what prefill writes
  into the cache slots;
* :meth:`TransformerTagger.decode_step` — one token per slot against the
  slot-major cache ``[S, layers, H, T_max, head_dim]``, attention through
  ``decode_attention`` (the CUDA kernel on the card).

The JAX decode writes the cache functionally (``ck.at[rows, i, :,
positions].set(k)``) and then keeps the inactive rows with a whole-cache
``jnp.where``. Here the new K/V rows are written in place, and only for the
active slots (``index_put_``): the same result, without copying the cache
(2.4 GB a layer at the GPT-2-small serving size) per layer and step.

BiLSTM, the MoE FFN, ``mesh_hooks``, ``pad_sequences`` and
``bucket_batches`` are not part of this port yet.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.plan import _upload
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.vit import _TRUNC_STD, Dense, LayerNorm
from mmlspark_tpu_torch.ops.attention import decode_attention


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where -inf marks masked entries; rows
    with every entry masked give zero weights (not NaN)."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m)  # exp(-inf) == 0 for masked entries
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _local_attention(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """Plain softmax attention: ``[B, Lq, H, D]`` x ``[B, Lk, H, D]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", _masked_softmax(scores), v)


def attention_reference(q, k, v, causal: bool = False, kv_mask=None
                        ) -> torch.Tensor:
    """Single-device attention over ``[B, L, H, D]`` operands; ``kv_mask``
    ``[B, Lk]`` bool, True for real (non-pad) keys."""
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    mask = None
    if causal:
        n = q.shape[1]
        mask = torch.ones((n, n), dtype=torch.bool,
                          device=q.device).tril()[None, None]
    if kv_mask is not None:
        key_mask = kv_mask.to(torch.bool)[:, None, None, :]
        mask = key_mask if mask is None else (mask & key_mask)
    return _local_attention(q, k, v, scale, mask)


class _Block(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, device):
        super().__init__()
        f32 = torch.float32
        self.ln_a = LayerNorm(dim, f32, device)
        self.qkv = Dense(dim, 3 * dim, f32, device)
        self.proj = Dense(dim, dim, f32, device)
        self.ln_b = LayerNorm(dim, f32, device)
        self.mlp_in = Dense(dim, mlp_dim, f32, device)
        self.mlp_out = Dense(mlp_dim, dim, f32, device)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.mlp_in(self.ln_b(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerTagger(nn.Module):
    """Causal (or bidirectional) Transformer over ``[B, L]`` int tokens;
    logits ``[B, L, num_tags]``. Built on ``device`` (None = cuda, which
    raises without a card; ``"cpu"`` when asked)."""

    def __init__(self, vocab_size: int = 1024, embed_dim: int = 64,
                 num_heads: int = 4, num_layers: int = 2, mlp_dim: int = 128,
                 num_tags: int = 8, max_len: int = 2048,
                 causal: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.num_tags = num_tags
        self.max_len = max_len
        self.causal = causal
        self.embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.pos_embed = nn.Parameter(
            torch.empty(max_len, embed_dim, device=device))
        self.blocks = nn.ModuleList(_Block(embed_dim, mlp_dim, device)
                                    for _ in range(num_layers))
        self.ln_f = LayerNorm(embed_dim, torch.float32, device)
        self.head = Dense(embed_dim, num_tags, torch.float32, device)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def forward(self, tokens: torch.Tensor, mask=None,
                return_cache: bool = False):
        """Full forward. ``tokens`` ``[B, L]``; ``mask`` ``[B, L]`` bool
        (True = real token; pad keys are excluded from attention). Returns
        logits ``[B, L, num_tags]``, and with ``return_cache`` also
        ``(ck, cv)``, each ``[B, layers, H, L, head_dim]``."""
        b, n = tokens.shape
        if n > self.max_len:
            raise ValueError(f"{n} tokens > max_len {self.max_len}")
        h, hd = self.num_heads, self.head_dim
        x = self.embed(tokens.long()) + self.pos_embed[None, :n]
        kv_mask = None if mask is None else mask.to(x.device, torch.bool)
        kv_layers = []
        for blk in self.blocks:
            q, k, v = blk.qkv(blk.ln_a(x)).split(self.embed_dim, dim=-1)
            q = q.reshape(b, n, h, hd)
            k = k.reshape(b, n, h, hd)
            v = v.reshape(b, n, h, hd)
            if return_cache:
                kv_layers.append((k.transpose(1, 2), v.transpose(1, 2)))
            attn = attention_reference(q, k, v, causal=self.causal,
                                       kv_mask=kv_mask)
            x = x + blk.proj(attn.reshape(b, n, self.embed_dim))
            x = blk.mlp(x)
        logits = self.head(self.ln_f(x))
        if return_cache:
            ck = torch.stack([k for k, _ in kv_layers], dim=1)
            cv = torch.stack([v for _, v in kv_layers], dim=1)
            return logits, (ck, cv)
        return logits

    def decode_step(self, tokens: torch.Tensor, cache: tuple, positions,
                    update_mask=None,
                    decode_attention_fn: Callable | None = None):
        """One token step against the slot-major KV cache.

        ``tokens`` ``[S, 1]``; ``cache`` ``(ck, cv)``, each ``[S, layers,
        H, T, head_dim]`` float32, updated in place; ``positions`` ``[S]``,
        each slot's write index (its current length); ``update_mask``
        ``[S]`` bool, None for every slot: the rows where it is False keep
        their cache bits and attend to nothing. The active rows are found
        on the host: pass the mask as a CPU tensor or numpy array, or the
        call waits for the card to copy it back. ``decode_attention_fn(q,
        k_layer, v_layer, keep)`` (``keep`` ``[S, T]`` int8, nonzero =
        attend) defaults to :func:`decode_attention`.
        Returns ``(logits [S, num_tags], (ck, cv))``."""
        attend = decode_attention_fn or (
            lambda q, k, v, keep: decode_attention(q, k, v, kv_mask=keep))
        ck, cv = cache
        dev = ck.device
        s_ = tokens.shape[0]
        t_max = ck.shape[3]
        h, hd = self.num_heads, self.head_dim
        positions = torch.as_tensor(positions, dtype=torch.long)
        if positions.device != dev:
            positions = _upload(positions.numpy(), dev)
        keep = (torch.arange(t_max, device=dev)[None, :]
                <= positions[:, None])
        if update_mask is None:
            rows = torch.arange(s_, device=dev)
        else:
            mask = torch.as_tensor(update_mask, dtype=torch.bool).cpu()
            rows = _upload(mask.nonzero()[:, 0].numpy(), dev)
            keep = keep & _upload(mask.numpy(), dev)[:, None]
        # int8, the decode kernel's mask type: converted once, not per layer
        keep = keep.to(torch.int8)
        write_at = positions[rows]
        x = self.embed(tokens.long()) + self.pos_embed[positions][:, None]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.qkv(blk.ln_a(x)).split(self.embed_dim, dim=-1)
            q = q.reshape(s_, h, hd)
            # the layer's slice seen as [S, T, H, hd]: row (slot, position)
            ck[:, i].transpose(1, 2).index_put_(
                (rows, write_at), k.reshape(s_, h, hd)[rows])
            cv[:, i].transpose(1, 2).index_put_(
                (rows, write_at), v.reshape(s_, h, hd)[rows])
            attn = attend(q, ck[:, i], cv[:, i], keep)
            x = x + blk.proj(attn.reshape(s_, 1, self.embed_dim))
            x = blk.mlp(x)
        logits = self.head(self.ln_f(x))[:, 0]
        return logits, (ck, cv)


@torch.no_grad()
def init_sequence_(model: TransformerTagger,
                   generator: torch.Generator) -> TransformerTagger:
    """Fill every parameter from ``generator`` with flax's initializers:
    truncated LeCun-normal ``Dense`` kernels, zero biases, unit LayerNorm
    scales, ``N(0, 0.02)`` ``pos_embed``, and the ``Embed`` default (normal
    with stddev ``1/sqrt(embed_dim)``). The numbers differ from flax's
    for the same seed; parity tests convert the JAX weights instead."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            w = mod.weight
            std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    model.embed.weight.normal_(0.0, 1.0 / math.sqrt(model.embed_dim),
                               generator=generator)
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
