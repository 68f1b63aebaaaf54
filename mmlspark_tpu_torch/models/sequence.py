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
  tokens with a ``[B, L]`` pad mask (from ``pad_token_id`` when none is
  passed); attention is the plain masked softmax of
  ``parallel/ring_attention.attention_reference`` (plain XLA in the JAX
  package, plain PyTorch here), or any ``attention_fn(q, k, v, kv_mask,
  causal)``: :meth:`TransformerTagger.mesh_hooks` gives the trainer the
  ring attention over a mesh's ``sp`` ranks, with the same weights.
  ``return_cache=True`` also returns every layer's K/V stacked ``[B,
  layers, H, L, head_dim]``: what prefill writes into the cache slots;
* :meth:`TransformerTagger.decode_step` — one token per slot against the
  slot-major cache ``[S, layers, H, T_max, head_dim]``, attention through
  ``decode_attention`` (the CUDA kernel on the card).

The JAX decode writes the cache functionally (``ck.at[rows, i, :,
positions].set(k)``) and then keeps the inactive rows with a whole-cache
``jnp.where``. Here the new K/V rows are written in place, and only for the
active slots (``index_put_``): the same result, without copying the cache
(2.4 GB a layer at the GPT-2-small serving size) per layer and step.

The host helpers :func:`pad_sequences` and :func:`bucket_batches` build
padded token batches (numpy, copied from the JAX package). BiLSTM, the MoE
FFN and its ``ep`` mesh hook are not part of this port yet.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.plan import _upload
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.vit import _TRUNC_STD, Dense, LayerNorm
from mmlspark_tpu_torch.ops.attention import decode_attention
from mmlspark_tpu_torch.parallel.ring_attention import (
    attention_reference, ring_attention,
)


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
                 causal: bool = False, pad_token_id: int | None = None,
                 device=None):
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
        # when set and no mask is passed, tokens equal to this id are
        # padding: how Trainer.fit_arrays's plain (tokens, tags) batches
        # reach the attention mask and the per-token loss
        self.pad_token_id = pad_token_id
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
                return_cache: bool = False,
                attention_fn: Callable | None = None):
        """Full forward. ``tokens`` ``[B, L]``; ``mask`` ``[B, L]`` bool
        (True = real token; pad keys are excluded from attention), or
        ``tokens != pad_token_id`` when None and the id is set.
        ``attention_fn(q, k, v, kv_mask, causal)`` over ``[B, L, H,
        head_dim]`` defaults to :func:`attention_reference`. Returns
        logits ``[B, L, num_tags]``, and with ``return_cache`` also
        ``(ck, cv)``, each ``[B, layers, H, L, head_dim]``."""
        b, n = tokens.shape
        if n > self.max_len:
            raise ValueError(f"{n} tokens > max_len {self.max_len}")
        if mask is None and self.pad_token_id is not None:
            mask = tokens != self.pad_token_id
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
            if attention_fn is None:
                attn = attention_reference(q, k, v, causal=self.causal,
                                           kv_mask=kv_mask)
            else:
                attn = attention_fn(q, k, v, kv_mask, self.causal)
            x = x + blk.proj(attn.reshape(b, n, self.embed_dim))
            x = blk.mlp(x)
        logits = self.head(self.ln_f(x))
        if return_cache:
            ck = torch.stack([k for k, _ in kv_layers], dim=1)
            cv = torch.stack([v for _, v in kv_layers], dim=1)
            return logits, (ck, cv)
        return logits

    def mesh_hooks(self, mesh) -> dict:
        """Trainer integration (``train/loop.resolve_mesh_hooks``): on a
        mesh with ``sp > 1`` attention runs as the ring over its ``sp``
        ranks, with the same weights."""
        kwargs: dict = {}
        handled: set = set()
        if mesh.shape.get("sp", 1) > 1:
            def attention_fn(q, k, v, kv_mask, causal, _mesh=mesh):
                return ring_attention(q, k, v, _mesh, causal=causal,
                                      kv_mask=kv_mask)

            kwargs["attention_fn"] = attention_fn
            handled.add("sp")
        return {"apply_kwargs": kwargs, "handled": handled}

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


# ---- padded/bucketed batching (copied from the JAX package, numpy) ----

def _check_sequence(i: int, s) -> np.ndarray:
    """Validate one token sequence; returns it as an int32 array. An empty
    sequence or non-integer tokens raise instead of padding silently."""
    arr = np.asarray(s)
    if arr.ndim != 1:
        raise ValueError(
            f"sequence {i} has shape {arr.shape}; expected a flat 1-D "
            "token sequence")
    if arr.size == 0:
        raise ValueError(
            f"sequence {i} is empty; an empty sequence has no tokens to "
            "tag (drop it before batching)")
    if not np.issubdtype(arr.dtype, np.integer):
        if arr.dtype == bool or not np.issubdtype(arr.dtype, np.number) \
                or not np.array_equal(arr, arr.astype(np.int64)):
            raise TypeError(
                f"sequence {i} has non-integer tokens (dtype "
                f"{arr.dtype}); token ids must be integers")
    return arr.astype(np.int32)


def pad_sequences(seqs: Sequence[Sequence[int]], length: int,
                  pad_value: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad token sequences to ``length``; returns ``(tokens, mask)``.
    Raises ``ValueError`` for empty or overlong sequences (never
    truncates) and ``TypeError`` for non-integer tokens."""
    out = np.full((len(seqs), length), pad_value, dtype=np.int32)
    mask = np.zeros((len(seqs), length), dtype=bool)
    for i, s in enumerate(seqs):
        arr = _check_sequence(i, s)
        n = arr.shape[0]
        if n > length:
            raise ValueError(
                f"sequence {i} has {n} tokens > pad length {length}; "
                "truncation would silently drop tokens")
        out[i, :n] = arr
        mask[i, :n] = True
    return out, mask


def bucket_batches(seqs: Sequence[Sequence[int]], batch_size: int,
                   bucket_sizes: Sequence[int] = (64, 128, 256, 512, 1024),
                   pad_value: int = 0):
    """Group sequences into fixed-shape padded batches, each sequence in
    the smallest bucket that covers it. Yields ``(tokens [b, bucket],
    mask, indices)`` with the original row indices. Raises ``ValueError``
    for an empty sequence or one longer than the largest bucket and
    ``TypeError`` for non-integer tokens."""
    bucket_sizes = sorted(bucket_sizes)
    buckets: dict[int, list[int]] = {b: [] for b in bucket_sizes}
    overflow = max(bucket_sizes)
    for i, s in enumerate(seqs):
        n = _check_sequence(i, s).shape[0]
        if n > overflow:
            raise ValueError(
                f"sequence {i} has {n} tokens > largest bucket "
                f"{overflow}; truncation would silently drop tokens")
        for b in bucket_sizes:
            if n <= b:
                buckets[b].append(i)
                break
    for b, idxs in buckets.items():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            toks, mask = pad_sequences([seqs[i] for i in chunk], b,
                                       pad_value)
            yield toks, mask, np.asarray(chunk)
