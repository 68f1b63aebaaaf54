"""Sequence parallelism: ring attention over the ``sp`` ranks of a mesh.

The port of ``mmlspark_tpu/parallel/ring_attention.py:ring_attention`` and
the plain attention it is held against (:func:`attention_reference`, which
the sequence models also use as their single-device attention).

In the JAX package each ``sp`` device keeps its query shard resident while
the K/V shards and their pad mask travel once around the ring
(``ppermute`` with ``perm=(i, i+1)``), one online-softmax block update per
hop (the Pallas kernel ``_update_call``). Here the ``sp`` ranks are virtual
ranks on one card (:mod:`mmlspark_tpu_torch.parallel.mesh`): the global
``[B, L, H, D]`` operands are folded once into a rank-major
``[sp·B, H, l, D]`` batch (``l = L / sp``; one float32 copy), and every hop
is ONE call of :func:`~mmlspark_tpu_torch.ops.attention.attention_block_update`
over all ranks at once — each (rank, batch, head) tile is the work one
device does in that hop. The collective-permute becomes a rotation of the
rank axis (:func:`_ring_shift`, ``torch.roll`` by one:
``new[r] = old[r − 1]``, so after ``step`` hops rank ``r`` holds key block
``(r − step) mod sp``, as in the JAX body). The hop schedule, the carried
``(m, denom, acc)``, the causal relation of the two blocks' positions and
the ``1e-30`` floor of the final division are the JAX package's; a ``dp``
axis changes no number (each dp group's ring is a slice of the batch axis
the fold already carries).
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.ops.attention import attention_block_update


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


def _ring_shift(blocks: tuple) -> tuple:
    """One hop of the ring: every rank sends its resident blocks to the
    next rank (rank-major tensors ``[sp, ...]``; the JAX package's
    ``ppermute`` with ``perm=(i, i+1)``). The only place the ring moves
    data between ranks."""
    return tuple(torch.roll(x, 1, dims=0) for x in blocks)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   kv_mask=None, batch_axis: str | None = "dp",
                   impl: str = "auto") -> torch.Tensor:
    """Attention over sequence shards, the ``axis`` ranks of ``mesh``.

    ``q``/``k``/``v``: global ``[B, L, H, D]`` tensors; ``L`` must divide
    by the ``axis`` size and ``B`` by the ``batch_axis`` size, as the JAX
    package's sharding requires. ``kv_mask`` ``[B, L]`` bool (True = real
    key) rotates around the ring with its K/V block. Returns ``[B, L, H,
    D]`` in q's dtype; fully masked query rows are exact zeros. ``impl``
    (``auto|cuda|torch``) selects the per-hop block update, the kernel on
    the card under ``auto``; the hop schedule is the same either way."""
    b, n, h, d = q.shape
    sp = mesh.shape[axis]
    dp = mesh.shape.get(batch_axis, 1) if batch_axis is not None else 1
    if n % sp:
        raise ValueError(f"sequence length {n} does not divide over the "
                         f"{axis!r} axis ({sp} ranks)")
    if b % dp:
        raise ValueError(f"batch {b} does not divide over the "
                         f"{batch_axis!r} axis ({dp} ranks)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    l_ = n // sp
    scale = float(np.float32(1.0 / np.sqrt(d)))
    dev = q.device

    def fold(x):
        # [B, L, H, D] -> [sp, B, H, l, D]: rank-major, one f32 copy
        return x.float().reshape(b, sp, l_, h, d).permute(1, 0, 3, 2, 4) \
            .contiguous()

    if kv_mask is None:
        kv_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    mask = kv_mask.to(device=dev, dtype=torch.bool)
    if tuple(mask.shape) != (b, n):
        raise ValueError(f"kv_mask must be [B, L] = {(b, n)}, got "
                         f"{tuple(mask.shape)}")
    qf = fold(q).reshape(sp * b, h, l_, d)
    kv = (fold(k), fold(v), mask.reshape(b, sp, l_).transpose(0, 1)
          .contiguous())
    m = torch.full((sp * b, h, l_, 1), float("-inf"), dtype=torch.float32,
                   device=dev)
    denom = torch.zeros((sp * b, h, l_, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((sp * b, h, l_, d), dtype=torch.float32, device=dev)
    ranks = torch.arange(sp, device=dev)
    offs = torch.arange(l_, device=dev)
    q_pos = ranks[:, None] * l_ + offs[None, :]                   # [sp, l]
    for step in range(sp):
        kc, vc, mc = kv
        # [sp, B, l, l]: rank r's queries against its resident key block
        keep = mc[:, :, None, :].expand(sp, b, l_, l_)
        if causal:
            kv_idx = (ranks - step) % sp
            k_pos = kv_idx[:, None] * l_ + offs[None, :]
            keep = keep & (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
        m, denom, acc = attention_block_update(
            qf, kc.reshape(sp * b, h, l_, d), vc.reshape(sp * b, h, l_, d),
            keep.reshape(sp * b, l_, l_).to(torch.int8), m, denom, acc,
            scale, impl=impl)
        if step + 1 < sp:
            kv = _ring_shift(kv)
    out = acc / torch.clamp(denom, min=1e-30)                # [sp·B,H,l,D]
    out = out.reshape(sp, b, h, l_, d).permute(1, 0, 3, 2, 4)
    return out.reshape(b, n, h, d).to(q.dtype)
