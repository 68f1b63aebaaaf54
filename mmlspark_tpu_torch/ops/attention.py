"""Flash and decode attention: the hand-written CUDA kernels and their plain
PyTorch versions.

The port of ``mmlspark_tpu/ops/pallas/attention.py:flash_attention`` (the
Pallas kernel ``_flash_call``), the serving-path attention of the ViT.
Same function: q/k/v ``[B, H, T, D]`` in bfloat16 or float32, upcast to
float32; one ``[B, Tq, Tk]`` int8 keep-mask shared by every head, built
from ``kv_mask`` (``[B, Tk]``, True = real key) and ``causal``; the
online softmax over key blocks with a running max and denominator; the
f32 scale ``1/sqrt(D)``; float32 output ``[B, H, Tq, D]``, with fully
masked query rows exact zeros through the denominator floor ``1e-30``.

* :func:`flash_attention_reference` is the plain version, written from
  the JAX package's ``_online_update``/``_flash_tile`` (block loop, the
  ``-inf`` guards and the floor), batched over (batch, head). The CPU
  tests hold it against the JAX function; ``chip_smoke.py`` holds the
  kernel against it on the card.
* :func:`flash_attention` dispatches on ``impl``: ``"auto"`` takes the
  kernel for CUDA tensors and the plain version for CPU tensors;
  ``"cuda"`` and ``"torch"`` force one or the other. A CUDA tensor under
  ``"auto"`` reaches the kernel or raises — there is no fallback.
* ``launches`` counts the kernel's launches (one per call that reaches
  ``ops/csrc/flash_attention.cu``), so a run can show that its path went
  through the kernel.

The kernel supports head widths ``D <= 128`` with ``D % 8 == 0``; the
wrapper raises on any other ``D``, on another dtype, on operands on
different devices, and on operands whose last axis is not contiguous (the
kernel takes batch/head/token strides, so the ``[B,T,H,D] → [B,H,T,D]``
transpose of the projections needs no copy). The bf16 instance runs on
the tensor cores and copies 16 bytes at a time, so for bf16 operands it
also raises unless every base pointer is 16-byte aligned and every
batch/head/token stride is a multiple of 8 elements
(:func:`check_kernel_layout`); it never copies to fix a layout. The f32
instance takes any such strides.

Decode attention is the port of
``mmlspark_tpu/ops/pallas/attention.py:decode_attention`` (the Pallas kernel
``_decode_call``), the token-generation path's attention: one query row
per slot, q ``[S, H, D]``, against the slot-major f32 KV cache k/v
``[S, H, Tk, D]``, with one ``[S, Tk]`` int8 keep-mask shared by every
head (:func:`decode_mask2`). :func:`decode_attention_reference` is its
plain version (the same recurrence over key blocks, both contractions as
multiply + sum, as ``_decode_tile`` writes them); :func:`decode_attention`
dispatches on ``impl`` like :func:`flash_attention`; ``decode_launches``
counts the launches of ``ops/csrc/decode_attention.cu``. The kernel takes
float32 operands and ``D <= 128`` with ``D % 8 == 0``; the wrapper raises
on anything else, whichever route is taken.

The ring-hop block update is the port of
``mmlspark_tpu/ops/pallas/attention.py:attention_block_update`` (the
Pallas kernel ``_update_call``), the per-hop local block of
``parallel/ring_attention.ring_attention``: one online-softmax update of a
carried ``(m, denom, acc)`` over a whole K/V block, q ``[N, H, Tq, D]``,
k/v ``[N, H, Tk, D]``, one ``[N, Tq, Tk]`` keep-mask shared by every head,
all float32. :func:`block_update_reference` is its plain version (the JAX
package's ``xla`` route: one ``_online_update`` over the whole block, no
inner key-block loop); :func:`attention_block_update` dispatches on
``impl`` like the others; ``block_update_launches`` counts the launches of
``ops/csrc/block_update.cu``. The kernel route is an autograd function
whose backward is a kernel too (``ops/csrc/block_update_bwd.cu``, two
launches a call): the JAX package differentiates ``_online_update`` with
``jax.vjp`` through XLA, and the kernel computes that vjp in closed form.
:func:`block_update_backward_reference` is its plain version (the same
closed form in plain PyTorch, no autograd) and
:func:`block_update_backward_error_bound` the tolerance it is held to;
:func:`block_update_backward` (the plain update recomputed under autograd)
stays as a measured reference, and nothing on the card's path calls it.
``block_update_backward_launches`` counts the backward kernel's calls and
``block_update_backward_copies`` the cotangents it had to copy (not
contiguous, or ``g_acc`` off 16 bytes).
The wrapper makes every operand contiguous (the ring's rank-major fold is
a copy already) and raises on non-float32 operands, mismatched shapes and
a ``D`` the kernel does not take, whichever route is taken.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

IMPLS = ("auto", "cuda", "torch")

# key-block width of the plain version's online-softmax loop (the JAX
# package's DEFAULT_BLOCK_K); the kernel walks keys in its own stripes
DEFAULT_BLOCK_K = 128

# the denominator guard for fully-masked query rows
_DENOM_FLOOR = 1e-30

MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernels; reset by whoever reads them
launches = 0
decode_launches = 0
block_update_launches = 0
block_update_backward_launches = 0
block_update_backward_copies = 0
_count_lock = threading.Lock()


def _online_update(q, ks, vs, keep, m, denom, acc, scale,
                   matmul=torch.matmul):
    """One key block's update of the online softmax, batched: ``q``
    ``[..., Tq, D]`` f32, ``ks``/``vs`` ``[..., bk, D]`` f32, ``keep``
    ``[..., Tq, bk]`` bool, carry ``m``/``denom`` ``[..., Tq, 1]`` and
    ``acc`` ``[..., Tq, D]`` f32. ``matmul`` takes the two products (the
    scores and p·v)."""
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32,
                           device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    scores = matmul(q, ks.transpose(-1, -2)) * scale
    scores = torch.where(keep, scores, neg_inf)
    blk_max = scores.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, blk_max)
    # guard -inf - -inf (rows with every key masked so far)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), zero)
    p = torch.exp(torch.where(torch.isfinite(scores), scores - m_new,
                              neg_inf))
    acc = acc * corr + matmul(p, vs)
    denom = denom * corr + p.sum(dim=-1, keepdim=True)
    return m_new, denom, acc


def flash_attention_reference(q, k, v, mask3, scale,
                              block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch flash attention: the block loop of
    ``_flash_tile`` over (batch, head) at once. ``q``/``k``/``v``
    ``[B, H, T, D]`` of any float dtype (upcast to f32), ``mask3``
    ``[B, Tq, Tk]`` int8 (nonzero = attend). Returns ``[B, H, Tq, D]``
    float32."""
    q = q.float()
    k = k.float()
    v = v.float()
    keep = (mask3 != 0)[:, None]                      # [B, 1, Tq, Tk]
    b, h, tq, d = q.shape
    tk = k.shape[2]
    m = torch.full((b, h, tq, 1), float("-inf"), dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    s = float(np.float32(scale))
    for start in range(0, tk, block_k):
        stop = min(start + block_k, tk)
        m, denom, acc = _online_update(
            q, k[:, :, start:stop], v[:, :, start:stop],
            keep[..., start:stop], m, denom, acc, s)
    return acc / torch.clamp(denom, min=_DENOM_FLOOR)


def mask3(b: int, tq: int, tk: int, kv_mask, causal: bool,
          device) -> torch.Tensor:
    """The one ``[B, Tq, Tk]`` int8 keep-mask every implementation
    consumes (1 = attend), contiguous."""
    if kv_mask is None:
        keep = torch.ones((b, tq, tk), dtype=torch.bool, device=device)
    else:
        kv = torch.as_tensor(kv_mask, device=device).to(torch.bool)
        if tuple(kv.shape) != (b, tk):
            raise ValueError(
                f"kv_mask must be [B, Tk] = {(b, tk)}, got {tuple(kv.shape)}")
        keep = kv[:, None, :].expand(b, tq, tk)
    if causal:
        keep = keep & torch.ones((tq, tk), dtype=torch.bool,
                                 device=device).tril()[None]
    return keep.to(torch.int8).contiguous()


def resolve_scale(scale, d: int) -> float:
    """The f32 softmax scale, as the Python float of an f32 value so that
    every implementation multiplies by the bit-identical constant."""
    return float(np.float32(1.0 / np.sqrt(d) if scale is None else scale))


def resolve_impl(impl: str, q: torch.Tensor) -> str:
    """``auto`` → the kernel for CUDA tensors, the plain version for CPU
    tensors. ``cuda`` on CPU tensors raises. Meta tensors (a shape trace,
    no data) take the plain version whatever the route asked for."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    if q.is_meta:
        return "torch"
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    if impl == "cuda" and not q.is_cuda:
        raise ValueError(
            "impl='cuda' runs the CUDA kernel and needs CUDA tensors; "
            f"got tensors on {q.device}")
    return impl


def _check_operands(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, T, D], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(
                f"{name} has dtype {t.dtype}; flash_attention takes "
                "torch.float32 or torch.bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d > MAX_D or d % 8:
        raise ValueError(
            f"head width D={d} unsupported: the kernel takes D <= {MAX_D} "
            "with D a multiple of 8")


def _kernel_fn():
    """The C entry point of ``ops/csrc/flash_attention.cu``, built on
    first use, with every argument typed (pointers and the stream as
    ``c_void_p``: untyped, ctypes would pass them as 32-bit ints)."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_strides(t: torch.Tensor) -> list[int]:
    """The batch/head/token strides the kernel indexes with; an axis of
    size 1 is only ever read at index 0, so its stride (which PyTorch
    leaves arbitrary) is passed as 0."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def check_kernel_layout(q, k, v) -> None:
    """Raise unless the kernel can read ``q``/``k``/``v`` as they lie: a
    contiguous last axis for both instances, and for bfloat16 (whose
    instance copies 16 bytes at a time) 16-byte aligned base pointers and
    batch/head/token strides in multiples of 8 elements. Nothing is
    copied to make a layout fit."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(
                f"{name} must have a contiguous last axis (the kernel takes "
                f"batch/head/token strides); got strides {t.stride()}")
        if t.dtype != torch.bfloat16:
            continue
        strides = _kernel_strides(t)
        if t.data_ptr() % 16 or any(s % 8 for s in strides):
            raise ValueError(
                f"{name} is misaligned for the bf16 kernel's 16-byte "
                f"copies: it needs a 16-byte aligned base and batch/head/"
                f"token strides in multiples of 8 elements; got base "
                f"offset {t.data_ptr() % 16} bytes and strides "
                f"{t.stride()}")


def _flash_cuda(q, k, v, keep, scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream; the output is allocated
    here, the kernel allocates nothing."""
    global launches
    check_kernel_layout(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    fn = _kernel_fn()
    out = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with _count_lock:
            launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
                 out.data_ptr(), _DTYPES[q.dtype], b, h, tq, tk, d,
                 *_kernel_strides(q), *_kernel_strides(k),
                 *_kernel_strides(v),
                 scale, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(B={b}, H={h}, Tq={tq}, Tk={tk}, D={d}, dtype={q.dtype})")
    return out


def flash_attention(q, k, v, kv_mask=None, causal: bool = False,
                    scale=None, impl: str = "auto",
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Fused attention over ``[B, H, T, D]`` operands. ``kv_mask``:
    ``[B, Tk]`` bool key-validity mask (True = real key); ``causal`` adds
    the lower-triangular constraint. Returns ``[B, H, Tq, D]`` float32
    (callers cast back to their compute dtype); fully-masked query rows
    are exact zeros. ``block_k`` is the plain version's key-block width;
    the kernel uses its own stripes."""
    _check_operands(q, k, v)
    route = resolve_impl(impl, q)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    keep = mask3(b, tq, tk, kv_mask, causal, q.device)
    s = resolve_scale(scale, d)
    if route == "cuda":
        return _flash_cuda(q, k, v, keep, s)
    return flash_attention_reference(q, k, v, keep, s, block_k)


# ---- the KV-cache decode variant (one query row per slot) ----


def decode_mask2(s: int, tk: int, kv_mask, device) -> torch.Tensor:
    """The one ``[S, Tk]`` int8 validity mask every decode implementation
    consumes (nonzero = attend), contiguous. An int8 mask passes through
    unconverted, so a caller that attends many times against one mask
    converts it once."""
    if kv_mask is None:
        return torch.ones((s, tk), dtype=torch.int8, device=device)
    keep = torch.as_tensor(kv_mask, device=device)
    if tuple(keep.shape) != (s, tk):
        raise ValueError(
            f"kv_mask must be [S, Tk] = {(s, tk)}, got {tuple(keep.shape)}")
    if keep.dtype != torch.int8:
        keep = keep.to(torch.bool).to(torch.int8)
    return keep.contiguous()


def decode_attention_reference(q, k, v, mask2, scale,
                               block_k: int = DEFAULT_BLOCK_K):
    """Plain PyTorch decode attention: the block loop of ``_decode_tile``
    over (slot, head) at once, both contractions as broadcast-multiply +
    sum. ``q`` ``[S, H, D]``, ``k``/``v`` ``[S, H, Tk, D]``, ``mask2``
    ``[S, Tk]`` int8 (nonzero = attend). Returns ``[S, H, D]`` float32;
    a fully masked slot is exact zeros."""
    q = q.float()
    k = k.float()
    v = v.float()
    keep = (mask2 != 0)[:, None, :]                   # [S, 1, Tk]
    s_, h, d = q.shape
    tk = k.shape[2]
    dev = q.device
    neg_inf = float("-inf")
    m = torch.full((s_, h, 1), neg_inf, dtype=torch.float32,
                   device=dev)
    denom = torch.zeros((s_, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_, h, d), dtype=torch.float32, device=dev)
    sc = float(np.float32(scale))
    for start in range(0, tk, block_k):
        stop = min(start + block_k, tk)
        ks, vs = k[:, :, start:stop], v[:, :, start:stop]
        scores = (q[:, :, None, :] * ks).sum(dim=-1) * sc   # [S, H, bk]
        scores = torch.where(keep[..., start:stop], scores, neg_inf)
        blk_max = scores.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, blk_max)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.exp(torch.where(torch.isfinite(scores), scores - m_new,
                                  neg_inf))
        acc = acc * corr + (p[..., None] * vs).sum(dim=-2)
        denom = denom * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
    return acc / torch.clamp(denom, min=_DENOM_FLOOR)


def _check_decode_operands(q, k, v) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [S, H, D], got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} has dtype {t.dtype}; decode_attention takes the "
                "float32 cache and a float32 query")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    s_, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (s_, h) \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d > MAX_D or d % 8:
        raise ValueError(
            f"head width D={d} unsupported: the kernel takes D <= {MAX_D} "
            "with D a multiple of 8")


# decode_attention_fwd's C arguments: 5 pointers (q, k, v, mask, out), S,
# H, Tk, D, the 8 strides, the scale and the stream
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 8
                    + [ctypes.c_float, ctypes.c_void_p])


def _decode_kernel_fn():
    """The C entry point of ``ops/csrc/decode_attention.cu``, built on
    first use, every argument typed."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _DECODE_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _decode_cuda(q, k, v, keep, scale: float) -> torch.Tensor:
    """Launch the decode kernel on the current stream; the output is
    allocated here, the kernel allocates nothing."""
    global decode_launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(
                f"{name} must have a contiguous last axis (the kernel takes "
                f"the other strides); got strides {t.stride()}")
    # K and V rows are staged by 16-byte copies
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError(
                f"{name} rows must be 16-byte aligned: data_ptr "
                f"{t.data_ptr()}, strides {t.stride()}")
    s_, h, d = q.shape
    tk = k.shape[2]
    fn = _decode_kernel_fn()
    out = torch.empty((s_, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with _count_lock:
            decode_launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
                 out.data_ptr(), s_, h, tk, d, *q.stride()[:2],
                 *k.stride()[:3], *v.stride()[:3], scale, stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err} "
            f"(S={s_}, H={h}, Tk={tk}, D={d})")
    return out


def decode_attention(q, k, v, kv_mask=None, scale=None, impl: str = "auto",
                     block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Single-token decode attention against the cached K/V.

    ``q`` ``[S, H, D]`` (one query per slot), ``k``/``v`` ``[S, H, Tk, D]``
    (the slot-major cache, one layer's slice), ``kv_mask`` ``[S, Tk]``
    bool (True = valid cached position; typically ``arange(Tk) <=
    position``). Returns ``[S, H, D]`` float32; fully masked slots are
    exact zeros. ``block_k`` is the plain version's key-block width; the
    kernel splits each slot's valid key range over its warps and walks
    each warp's part in stages of 8 keys."""
    _check_decode_operands(q, k, v)
    route = resolve_impl(impl, q)
    s_, h, d = q.shape
    tk = k.shape[2]
    keep = decode_mask2(s_, tk, kv_mask, q.device)
    sc = resolve_scale(scale, d)
    if route == "cuda":
        return _decode_cuda(q, k, v, keep, sc)
    return decode_attention_reference(q, k, v, keep, sc, block_k)


# ---- the ring-hop block update (one online update over a whole block) ----


def block_update_reference(q4, k4, v4, keep3, m, denom, acc, scale,
                           matmul=torch.matmul):
    """Plain PyTorch block update: one :func:`_online_update` over the
    whole key block, batched over (N, H). ``keep3`` ``[N, Tq, Tk]``
    (nonzero = attend). Returns the fresh ``(m, denom, acc)``. ``matmul``
    takes the two products, so that another arithmetic for them, as the
    kernel's, can be held to the plain version on the CPU."""
    return _online_update(q4, k4, v4, (keep3 != 0)[:, None], m, denom, acc,
                          scale, matmul)


def _check_block_operands(q4, k4, v4, keep3, m, denom, acc) -> None:
    for name, t in (("q4", q4), ("k4", k4), ("v4", v4), ("m", m),
                    ("denom", denom), ("acc", acc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; "
                            "attention_block_update takes float32")
        if t.device != q4.device:
            raise ValueError(f"{name} is on {t.device}, q4 on {q4.device}")
    if keep3.device != q4.device:
        raise ValueError(f"keep3 is on {keep3.device}, q4 on {q4.device}")
    if q4.dim() != 4:
        raise ValueError(f"q4 must be [N, H, Tq, D], got {tuple(q4.shape)}")
    n, h, tq, d = q4.shape
    tk = k4.shape[2] if k4.dim() == 4 else -1
    want = {"k4": (n, h, tk, d), "v4": (n, h, tk, d), "keep3": (n, tq, tk),
            "m": (n, h, tq, 1), "denom": (n, h, tq, 1), "acc": (n, h, tq, d)}
    for name, t in (("k4", k4), ("v4", v4), ("keep3", keep3), ("m", m),
                    ("denom", denom), ("acc", acc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"shape mismatch: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]} for q4 "
                             f"{tuple(q4.shape)}")
    if d > MAX_D or d % 8:
        raise ValueError(
            f"head width D={d} unsupported: the kernel takes D <= {MAX_D} "
            "with D a multiple of 8")


def _block_update_fn():
    """The C entry point of ``ops/csrc/block_update.cu``, built on first
    use, every argument typed."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("block_update").block_update_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _block_update_cuda(q4, k4, v4, keep3, m, denom, acc, scale: float):
    """Launch the block-update kernel on the current stream; the fresh
    carry is allocated here, the kernel allocates nothing."""
    global block_update_launches
    q4, k4, v4, m, denom, acc = (t.contiguous() for t in
                                 (q4, k4, v4, m, denom, acc))
    keep = keep3 if keep3.dtype == torch.int8 else keep3.to(torch.bool).to(
        torch.int8)
    keep = keep.contiguous()
    n, h, tq, d = q4.shape
    tk = k4.shape[2]
    fn = _block_update_fn()
    m_out, d_out, a_out = (torch.empty_like(t) for t in (m, denom, acc))
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        with _count_lock:
            block_update_launches += 1
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                 keep.data_ptr(), m.data_ptr(), denom.data_ptr(),
                 acc.data_ptr(), m_out.data_ptr(), d_out.data_ptr(),
                 a_out.data_ptr(), n, h, tq, tk, d, scale, stream)
    if err != 0:
        raise RuntimeError(
            f"block_update kernel launch failed: cudaError {err} "
            f"(N={n}, H={h}, Tq={tq}, Tk={tk}, D={d})")
    return m_out, d_out, a_out


def block_update_backward(grads, q4, k4, v4, keep3, m, denom, acc,
                          scale: float):
    """The gradients of ``q4``, ``k4``, ``v4``, ``m``, ``denom`` and
    ``acc`` by autograd: the plain update recomputed and differentiated
    against ``grads``, the gradients of the fresh ``(m, denom, acc)``. A
    measured reference only; the kernel route's backward is
    :func:`_block_update_bwd_cuda`."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in
                  (q4, k4, v4, m, denom, acc)]
        q, k, v, m_, d_, a_ = inputs
        outs = block_update_reference(q, k, v, keep3, m_, d_, a_, scale)
        return torch.autograd.grad(outs, inputs, grads)


def _block_backward_terms(grads, q4, k4, v4, keep3, m, denom, acc,
                          scale: float, matmul=torch.matmul) -> dict:
    """The closed form's float32 terms: ``[N, H, Tq, Tk]`` scores ``s``
    (-inf where masked), ``p``, ``dp``, ``ds`` (= p·dp) and the tie mask,
    and per row ``[N, H, Tq, 1]`` the block max ``b``, ``m_new``, ``c``,
    ``dc``, ``dm_new``, the max's split ``to_m``/``to_b``, the count of
    tied keys and the ``share`` each takes; ``keep`` is ``[N, 1, Tq,
    Tk]``. ``matmul`` takes the products s and dp."""
    g_m, g_d, g_a = grads
    keep = (keep3 != 0)[:, None]
    s = torch.where(keep, matmul(q4, k4.transpose(-1, -2)) * scale,
                    float("-inf"))
    b = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, b)
    # guard -inf - -inf: c is 0 while m is -inf, p is 0 where masked
    c = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.where(keep, torch.exp(s - m_new), 0.0)
    dp = matmul(g_a, v4.transpose(-1, -2)) + g_d
    ds = p * dp
    dc = (g_a * acc).sum(dim=-1, keepdim=True) + g_d * denom
    dm_new = g_m - c * dc - ds.sum(dim=-1, keepdim=True)
    # torch.maximum and jnp.maximum pass half to each side at a tie; amax
    # and JAX's max split their share evenly over the tied keys
    zero = torch.zeros_like(dm_new)
    half = torch.where(m == b, 0.5 * dm_new, zero)
    to_m = torch.where(m > b, dm_new, half)
    to_b = torch.where(b > m, dm_new, half)
    tie = keep & (s == b)
    count = tie.sum(dim=-1, keepdim=True)
    share = torch.where(count > 0, to_b / count.clamp_min(1), zero)
    return {"keep": keep, "s": s, "b": b, "m_new": m_new, "c": c, "p": p,
            "dp": dp, "ds": ds, "dc": dc, "dm_new": dm_new, "to_m": to_m,
            "tie": tie, "count": count, "share": share}


def block_update_backward_reference(grads, q4, k4, v4, keep3, m, denom,
                                    acc, scale: float, matmul=torch.matmul):
    """The gradients of :func:`block_update_reference` at ``grads`` (those
    of the fresh ``(m, denom, acc)``) in closed form, plain PyTorch, no
    autograd: ``(dq, dk, dv, dm, ddenom, dacc)``, the order of
    :func:`block_update_backward`.

    ``dacc = c·gA``, ``ddenom = c·gD``; ``dp = gA·vᵀ + gD``, ``dv =
    pᵀ·gA``; ``dm' = gm − c·dc − Σ p·dp`` with ``dc = gA·acc + gD·denom``,
    split between ``m`` and the block max ``b`` as ``torch.maximum`` splits
    it (half each at a tie), ``b``'s part evenly over the kept keys that
    reach it; ``dm = c·dc + m's part``; ``ds = p·dp + each tied key's
    share``, ``dq = scale·ds·k``, ``dk = scale·dsᵀ·q``. A row with ``m =
    -inf`` and no kept key gets NaN in ``dm`` (as autograd of the plain
    update gives) and zeros elsewhere. ``matmul`` takes the five products
    (s, dp, dq, dk, dv), so that another arithmetic for them, as the
    kernel's, can be held to the error bound on the CPU."""
    t = _block_backward_terms(grads, q4, k4, v4, keep3, m, denom, acc,
                              scale, matmul)
    ds = t["ds"] + torch.where(t["tie"], t["share"], 0.0)
    dq = matmul(ds, k4) * scale
    dk = matmul(ds.transpose(-1, -2), q4) * scale
    dv = matmul(t["p"].transpose(-1, -2), grads[2])
    dm = torch.where(torch.isfinite(t["m_new"]), t["c"] * t["dc"] + t["to_m"],
                     float("nan"))
    return dq, dk, dv, dm, t["c"] * grads[1], t["c"] * grads[2]


def block_update_backward_error_bound(grads, q4, k4, v4, keep3, m, denom,
                                      acc, scale: float, rel: float,
                                      exact: bool = False):
    """How far another float32 evaluation of the closed form may lie from
    :func:`block_update_backward_reference` when its sums run in another
    order: bounds for ``(dq, dk, dv, dm, ddenom, dacc)``, float64.

    Every value moves by ``rel`` of the sizes of its terms (a sum taken in
    another order moves by a share of its terms' sizes, not of its own):
    a score by ``S = scale·|q|·|k|``, the block max and ``m'`` by the row's
    largest ``S`` (``σ``), ``p`` by ``p·(S + σ + |s − m'| + 1)``, ``c``
    likewise, ``dp`` by ``|gA|·|v| + |gD|``, each ``p·dp`` by the product
    of the two, ``dm'`` by the sizes of all its terms, and each output
    sum by its terms'. Unless ``exact`` (the inputs make every score exact
    on both sides), a row whose ``m`` and ``b`` lie within ``rel·σ`` of
    each other, or whose block max is within rounding of a second kept
    key, may split ``dm'`` the other way: it is granted ``|dm'|`` in
    ``dm`` and twice that times ``|k|`` and ``|q|`` for each such key in
    ``dq`` and ``dk``."""
    t = _block_backward_terms(grads, q4, k4, v4, keep3, m, denom, acc,
                              scale)
    f = torch.float64
    keep = t["keep"]
    g_m, g_d = grads[0].to(f), grads[1].to(f)
    aq, ak, av, aga = (x.to(f).abs() for x in (q4, k4, v4, grads[2]))
    s, b, mn = t["s"].to(f), t["b"].to(f), t["m_new"].to(f)
    p, dp, ds0 = t["p"].to(f), t["dp"].to(f), t["ds"].to(f)
    c, dc, mm = t["c"].to(f), t["dc"].to(f), m.to(f)
    big_s = torch.where(keep, scale * torch.matmul(aq, ak.transpose(-1, -2)),
                        0.0)
    sigma = big_s.amax(dim=-1, keepdim=True)
    e = big_s + sigma + torch.where(keep, (s - mn).abs(), 0.0) + 1
    dp_size = torch.matmul(aga, av.transpose(-1, -2)) + g_d.abs()
    w = p * (e * dp.abs() + dp_size) + ds0.abs()
    c_rel = torch.where(torch.isfinite(mm), sigma + (mm - mn).abs() + 1, 0.0)
    cdc = (c * dc).abs()
    dc_size = ((aga * acc.to(f).abs()).sum(dim=-1, keepdim=True)
               + (g_d * denom.to(f)).abs())
    y = c * (c_rel * dc.abs() + dc_size)
    big_m = g_m.abs() + cdc + y + w.sum(dim=-1, keepdim=True)
    per_tie = torch.where(
        t["count"] > 0,
        big_m / t["count"].clamp_min(1) + t["share"].to(f).abs(), 0.0)
    wt = w + torch.where(t["tie"], per_tie, 0.0)
    dq = rel * scale * torch.matmul(wt, ak)
    dk = rel * scale * torch.matmul(wt.transpose(-1, -2), aq)
    dv = rel * torch.matmul((p * (e + 1)).transpose(-1, -2), aga)
    dm = rel * (big_m + y + cdc)
    dden = rel * c * c_rel * g_d.abs()
    dacc = rel * c * c_rel * aga
    if not exact:
        live = torch.isfinite(b)
        near_mb = live & torch.isfinite(mm) & ((mm - b).abs() <= rel * sigma)
        near_key = keep & (s >= b - rel * (big_s + sigma))
        flip = live & (near_mb | (near_key.sum(dim=-1, keepdim=True) > 1))
        adm = torch.where(flip, t["dm_new"].to(f).abs() + rel * big_m, 0.0)
        allow = torch.where(near_key, 2 * adm, 0.0)
        dq = dq + scale * torch.matmul(allow, ak)
        dk = dk + scale * torch.matmul(allow.transpose(-1, -2), aq)
        dm = dm + torch.where(near_mb, adm, 0.0)
    return dq, dk, dv, dm, dden, dacc


# block_update_bwd's C arguments: 17 pointers (q, k, v, mask, the carry,
# the cotangents, the six gradients, the row scratch), N, H, Tq, Tk, D, the
# scale and the stream
_BLOCK_BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])


def _block_update_bwd_fn():
    """The C entry point of ``ops/csrc/block_update_bwd.cu``, built on
    first use, every argument typed."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("block_update_bwd").block_update_bwd
    if fn.argtypes is None:
        fn.argtypes = _BLOCK_BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _block_update_bwd_cuda(grads, q4, k4, v4, keep3, m, denom, acc,
                           scale: float):
    """Launch the backward kernel on the current stream; returns ``(dq, dk,
    dv, dm, ddenom, dacc)`` as :func:`block_update_backward_reference`
    does. A cotangent that is not contiguous, or a ``g_acc`` whose data
    does not start on 16 bytes, is copied first (counted in
    ``block_update_backward_copies``); so are q, k and v, uncounted. The
    outputs and the ``[N, H, Tq, 3]`` float32 row scratch are allocated
    here; the kernel allocates nothing."""
    global block_update_backward_launches, block_update_backward_copies
    if not q4.is_cuda:
        raise ValueError("the block-update backward kernel needs CUDA "
                         f"tensors; got q4 on {q4.device}")
    _check_block_operands(q4, k4, v4, keep3, m, denom, acc)
    gs = []
    for name, g, ref in zip(("g_m", "g_denom", "g_acc"), grads,
                            (m, denom, acc)):
        if g.shape != ref.shape or g.dtype != torch.float32 \
                or g.device != ref.device:
            raise ValueError(
                f"{name} {tuple(g.shape)} {g.dtype} on {g.device} does not "
                f"match {tuple(ref.shape)} float32 on {ref.device}")
        if not g.is_contiguous() or (name == "g_acc" and g.data_ptr() % 16):
            g = g.clone(memory_format=torch.contiguous_format)
            with _count_lock:
                block_update_backward_copies += 1
        gs.append(g)
    q4, k4, v4, m, denom, acc = (t.contiguous() for t in
                                 (q4, k4, v4, m, denom, acc))
    # the kernel stages q, k, v and gA by 16-byte copies
    q4, k4, v4 = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (q4, k4, v4))
    keep = keep3 if keep3.dtype == torch.int8 else keep3.to(torch.bool).to(
        torch.int8)
    keep = keep.contiguous()
    n, h, tq, d = q4.shape
    tk = k4.shape[2]
    fn = _block_update_bwd_fn()
    outs = [torch.empty_like(t) for t in (q4, k4, v4, m, denom, acc)]
    rowstat = torch.empty((n, h, tq, 3), dtype=torch.float32,
                          device=q4.device)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        with _count_lock:
            block_update_backward_launches += 1
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                 keep.data_ptr(), m.data_ptr(), denom.data_ptr(),
                 acc.data_ptr(), *(g.data_ptr() for g in gs),
                 *(o.data_ptr() for o in outs), rowstat.data_ptr(),
                 n, h, tq, tk, d, scale, stream)
    if err != 0:
        raise RuntimeError(
            f"block_update backward kernel launch failed: cudaError {err} "
            f"(N={n}, H={h}, Tq={tq}, Tk={tk}, D={d})")
    return tuple(outs)


class _BlockUpdateKernel(torch.autograd.Function):
    """The forward and backward kernels."""

    @staticmethod
    def forward(ctx, q4, k4, v4, keep3, m, denom, acc, scale):
        ctx.save_for_backward(q4, k4, v4, keep3, m, denom, acc)
        ctx.scale = scale
        return _block_update_cuda(q4, k4, v4, keep3, m, denom, acc, scale)

    @staticmethod
    def backward(ctx, g_m, g_denom, g_acc):
        q4, k4, v4, keep3, m, denom, acc = ctx.saved_tensors
        gq, gk, gv, gm, gd, ga = _block_update_bwd_cuda(
            (g_m, g_denom, g_acc), q4, k4, v4, keep3, m, denom, acc,
            ctx.scale)
        return gq, gk, gv, None, gm, gd, ga, None


def attention_block_update(q4, k4, v4, keep3, m, denom, acc, scale,
                           impl: str = "auto"):
    """One online-softmax update of the carry over a whole K/V block —
    ``ring_attention``'s per-hop local block.

    ``q4`` ``[N, H, Tq, D]``, ``k4``/``v4`` ``[N, H, Tk, D]``, ``keep3``
    ``[N, Tq, Tk]`` bool or int8 (nonzero = attend, shared by every head),
    carry ``m``/``denom`` ``[N, H, Tq, 1]`` and ``acc`` ``[N, H, Tq, D]``,
    all float32. Returns the fresh ``(m, denom, acc)``; the caller divides
    ``acc`` by ``max(denom, 1e-30)`` after its last block."""
    _check_block_operands(q4, k4, v4, keep3, m, denom, acc)
    route = resolve_impl(impl, q4)
    s = float(np.float32(scale))
    if route == "cuda":
        return _BlockUpdateKernel.apply(q4, k4, v4, keep3, m, denom, acc, s)
    return block_update_reference(q4, k4, v4, keep3, m, denom, acc, s)
