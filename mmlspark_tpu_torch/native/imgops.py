"""Host image ops in numpy: the port of ``mmlspark_tpu/native/imgops.py``
(``resize``, ``unroll``, ``unroll_batch``), whose native library is C++.

``resize`` computes the native library's ``img_resize_bilinear``
(``mmlspark_tpu/native/src/imgops.cpp``) operation for operation in
float32: align-corners source coordinates ``y · ((h − 1) / (oh − 1))``,
the four taps blended in its left-associated order
``v00·(1−wy)·(1−wx) + v01·(1−wy)·wx + v10·wy·(1−wx) + v11·wy·wx``, and a
truncating uint8 round of ``v + 0.5``. It is not OpenCV's half-pixel
``INTER_LINEAR``, which is another function. ``unroll`` is the library's
``img_unroll``: ``float(px) · scale + offset`` on the CHW view, with an
optional BGR → RGB swap.
"""

from __future__ import annotations

import numpy as np


def bilinear_taps(size: int, out: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(i0, i1, frac)`` of one axis: the two source indices of each of
    ``out`` align-corners samples over ``size`` and the float32 weight of
    ``i1``, as the native library computes them."""
    step = (np.float32(size - 1) / np.float32(out - 1) if out > 1
            else np.float32(0))
    f = np.arange(out, dtype=np.float32) * step
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, size - 1)
    return i0, i1, f - i0.astype(np.float32)


def resize(hwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear uint8 resize of one HWC image to ``(height, width)``."""
    a = np.ascontiguousarray(hwc, dtype=np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, _ = a.shape
    if min(h, w, height, width) <= 0:
        raise ValueError(f"resize failed for shape {a.shape} → "
                         f"({height}, {width})")
    y0, y1, wy = bilinear_taps(h, height)
    x0, x1, wx = bilinear_taps(w, width)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = np.float32(1)
    rows0, rows1 = a[y0], a[y1]
    v00 = rows0[:, x0].astype(np.float32)
    v01 = rows0[:, x1].astype(np.float32)
    v10 = rows1[:, x0].astype(np.float32)
    v11 = rows1[:, x1].astype(np.float32)
    v = (v00 * (one - wy) * (one - wx) + v01 * (one - wy) * wx
         + v10 * wy * (one - wx) + v11 * wy * wx)
    return (v + np.float32(0.5)).astype(np.uint8)


def unroll(hwc: np.ndarray, to_rgb: bool = False, scale: float = 1.0,
           offset: float = 0.0) -> np.ndarray:
    """HWC → CHW float32, ``px · scale + offset``, optionally BGR → RGB."""
    hwc = np.asarray(hwc)
    if hwc.ndim == 2:
        hwc = hwc[:, :, None]
    return unroll_batch(hwc[None], to_rgb, scale, offset)[0]


def unroll_batch(batch_hwc: np.ndarray, to_rgb: bool = False,
                 scale: float = 1.0, offset: float = 0.0) -> np.ndarray:
    """[N,H,W,C] → [N,C,H,W] float32, ``px · scale + offset``."""
    x = np.asarray(batch_hwc).astype(np.float32, copy=False)
    if to_rgb and x.shape[-1] == 3:
        x = x[..., ::-1]
    return (np.transpose(x, (0, 3, 1, 2)) * np.float32(scale)
            + np.float32(offset))
