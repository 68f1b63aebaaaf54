"""Fused per-sample crop → bilinear resize → scale: the hand-written CUDA
kernel and its plain PyTorch version.

The port of ``mmlspark_tpu/ops/pallas/resize.py`` (the Pallas kernel behind
``fused_resize_norm``), the geometry stage of on-device train
preprocessing. Sample ``i`` of a uint8 ``[N, H, W, C]`` batch takes the
``crop``-sized window at ``(oy[i], ox[i])``, resizes it to ``out_hw``
with align-corners bilinear taps, and comes out float32 ``× scale``.

Every implementation consumes ONE grid of taps and weights,
:func:`_grids` (a copy of the JAX package's, in numpy float32), so they
can be pinned against each other exactly:

* :func:`fused_resize_norm_reference` is the plain version: four gathers
  and the left-associated blend ``v00·w00 + v01·w01 + v10·w10 + v11·w11``
  as separate float32 operations, then ``× scale``;
* the kernel (``ops/csrc/resize.cu``) does the same operations in the same
  order with contraction into FMAs forbidden, so on the card it equals the
  plain version bit for bit.

Window offsets follow ``jax.lax.dynamic_slice``: a negative start counts
from the end of its axis (``o + H``), then the start is clamped into
``[0, H − ch] × [0, W − cw]``; a window larger than the source raises.
``launches`` counts calls that reach the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

IMPLS = ("auto", "cuda", "torch")

_THREADS = 256
_MAX_ELEMS = 2 ** 31 - 1

# launches of the CUDA kernel; reset by whoever reads it
launches = 0
_count_lock = threading.Lock()


def _grids(ch: int, cw: int, oh: int, ow: int) -> tuple:
    """Gather indices + blend weights for a (ch, cw) → (oh, ow)
    align-corners bilinear resize, all float math in numpy float32 (the
    JAX package's ``_grids``, copied)."""
    sy = (np.float32(ch - 1) / np.float32(oh - 1)) if oh > 1 else np.float32(0)
    sx = (np.float32(cw - 1) / np.float32(ow - 1)) if ow > 1 else np.float32(0)
    fy = np.arange(oh, dtype=np.float32) * sy
    fx = np.arange(ow, dtype=np.float32) * sx
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, ch - 1)
    x1 = np.minimum(x0 + 1, cw - 1)
    # subtract in f32: int32 operands would promote the weights to f64
    wy = (fy - y0.astype(np.float32)).reshape(oh, 1, 1)
    wx = (fx - x0.astype(np.float32)).reshape(1, ow, 1)
    one = np.float32(1)
    w00 = (one - wy) * (one - wx)
    w01 = (one - wy) * wx
    w10 = wy * (one - wx)
    w11 = wy * wx
    return y0, y1, x0, x1, w00, w01, w10, w11


@functools.lru_cache(maxsize=32)
def device_grids(ch: int, cw: int, oh: int, ow: int,
                 device: str) -> tuple:
    """The grid of one geometry on ``device``, uploaded once: row taps
    ``[2, OH]`` and column taps ``[2, OW]`` int32, weights
    ``[4, OH, OW]`` float32."""
    y0, y1, x0, x1, w00, w01, w10, w11 = _grids(ch, cw, oh, ow)
    yidx = torch.from_numpy(np.stack([y0, y1])).to(device)
    xidx = torch.from_numpy(np.stack([x0, x1])).to(device)
    wts = torch.from_numpy(
        np.ascontiguousarray(np.stack([w00, w01, w10, w11])[..., 0])
    ).to(device)
    return yidx, xidx, wts


def _check(x, oy, ox, crop, out_hw) -> tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"x has dtype {x.dtype}; fused_resize_norm takes "
                        "the uint8 wire form")
    n, h, w, _ = x.shape
    ch, cw = int(crop[0]), int(crop[1])
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if ch > h or cw > w:
        raise ValueError(f"crop window ({ch}, {cw}) larger than the "
                         f"source image ({h}, {w})")
    if min(ch, cw, oh, ow) < 1:
        raise ValueError(f"crop {crop} and out_hw {out_hw} must be >= 1")
    for name, t in (("oy", oy), ("ox", ox)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [N] = ({n},), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return ch, cw, oh, ow


def _clamped(o: torch.Tensor, size: int, limit: int) -> torch.Tensor:
    # dynamic_slice semantics: a negative start counts from the end of the
    # axis, then the start is clamped into bounds
    o = o.to(torch.int64)
    return torch.where(o < 0, o + size, o).clamp(0, limit)


def fused_resize_norm_reference(x, oy, ox, crop: tuple, out_hw: tuple,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch fused path: per-sample window gather, four bilinear
    taps, the left-associated blend and ``× scale``, batched."""
    ch, cw, oh, ow = _check(x, oy, ox, crop, out_hw)
    n, h, w, _ = x.shape
    yidx, xidx, wts = device_grids(ch, cw, oh, ow, str(x.device))
    ys = _clamped(oy, h, h - ch)[:, None, None] + yidx.to(torch.int64)
    xs = _clamped(ox, w, w - cw)[:, None, None] + xidx.to(torch.int64)
    # ys [N, 2, OH], xs [N, 2, OW] → taps [N, OH, OW, C]
    nn_ = torch.arange(n, device=x.device)[:, None, None]

    def tap(a: int, b: int) -> torch.Tensor:
        return x[nn_, ys[:, a, :, None], xs[:, b, None, :]].to(
            torch.float32)

    w00, w01, w10, w11 = (wts[k][..., None] for k in range(4))
    v = tap(0, 0) * w00 + tap(0, 1) * w01 + tap(1, 0) * w10 \
        + tap(1, 1) * w11
    return v * float(np.float32(scale))


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` → the kernel for CUDA tensors, the plain version for CPU
    tensors. ``cuda`` on CPU tensors raises. Meta tensors (a shape trace,
    no data) take the plain version whatever the route asked for."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fused_resize_norm impl {impl!r}; one of "
                         f"{IMPLS}")
    if x.is_meta:
        return "torch"
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(
            "impl='cuda' runs the CUDA kernel and needs CUDA tensors; "
            f"got tensors on {x.device}")
    return impl


def _kernel_fn():
    """The C entry point of ``ops/csrc/resize.cu``, built on first use,
    with every argument typed."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("resize").fused_resize_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _resize_cuda(x, oy, ox, crop, out_hw, scale) -> torch.Tensor:
    """Launch the kernel on the current stream; the output is allocated
    here, the kernel allocates nothing."""
    global launches
    ch, cw, oh, ow = _check(x, oy, ox, crop, out_hw)
    if not x.is_contiguous():
        raise ValueError(f"the resize kernel takes x contiguous [N, H, W, C];"
                         f" got strides {x.stride()}")
    n, h, w, c = x.shape
    if n * oh * ow * c > _MAX_ELEMS or x.numel() > _MAX_ELEMS:
        raise ValueError(f"batch {tuple(x.shape)} → {out_hw} exceeds the "
                         f"kernel's {_MAX_ELEMS} elements")
    yidx, xidx, wts = device_grids(ch, cw, oh, ow, str(x.device))
    oy32 = oy.to(torch.int32).contiguous()
    ox32 = ox.to(torch.int32).contiguous()
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=x.device)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _count_lock:
            launches += 1
        err = fn(x.data_ptr(), oy32.data_ptr(), ox32.data_ptr(),
                 yidx.data_ptr(), xidx.data_ptr(), wts.data_ptr(),
                 out.data_ptr(), n, h, w, c, ch, cw, oh, ow, _THREADS,
                 float(np.float32(scale)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_resize_norm kernel launch failed: cudaError {err} "
            f"(x {tuple(x.shape)}, crop {crop}, out {out_hw})")
    return out


def fused_resize_norm(x, oy, ox, crop: tuple, out_hw: tuple, scale: float,
                      impl: str = "auto") -> torch.Tensor:
    """Fused crop → bilinear resize → scale over a uint8 ``[N, H, W, C]``
    batch: sample ``i`` takes the ``crop`` window at ``(oy[i], ox[i])``
    (clamped into the image), resizes it to ``out_hw`` and returns float32
    ``* scale``. Raises on a crop larger than the source."""
    _check(x, oy, ox, crop, out_hw)
    if resolve_impl(impl, x) == "torch":
        return fused_resize_norm_reference(x, oy, ox, crop, out_hw, scale)
    return _resize_cuda(x, oy, ox, crop, out_hw, scale)
