"""Image stages: ImageTransformer (an op list) and UnrollImage — the port of
``mmlspark_tpu/stages/image.py`` (``ImageTransformer`` :171,
``UnrollImage`` :342).

On the host, ops run on decoded HWC uint8 arrays, threaded across rows:
resize and unroll through :mod:`mmlspark_tpu_torch.native.imgops`, crop
and flip as numpy slices, and the OpenCV-backed ops (``color_format``,
``blur``, ``threshold``, ``gaussian_kernel``) through ``cv2``, imported
when one of them runs. As device stages, resize, crop and flip (and the
unroll) run batched on the device tensor inside a fused segment; the
OpenCV-backed ops keep the host path.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.schema import make_image, mark_image_column
from mmlspark_tpu_torch.core.stage import (
    ArrayMeta, DeviceOp, DeviceStage, HasDevice, HasInputCol, HasOutputCol,
    Transformer,
)
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.native import imgops

# host threads over the rows of a column (numpy releases the GIL in the
# copies and the arithmetic)
IMAGE_THREADS = 8


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "this image op runs on OpenCV and cv2 is not installed; resize, "
            "crop and flip need no OpenCV") from e
    return cv2


# ---- host ops: (array HWC uint8, op params) -> array ----

def _op_resize(img: np.ndarray, p: Mapping) -> np.ndarray:
    return imgops.resize(img, int(p["height"]), int(p["width"]))


def _op_crop(img: np.ndarray, p: Mapping) -> np.ndarray:
    x, y = int(p.get("x", 0)), int(p.get("y", 0))
    h, w = int(p["height"]), int(p["width"])
    if y + h > img.shape[0] or x + w > img.shape[1]:
        raise ValueError(
            f"crop ({y}:{y+h}, {x}:{x+w}) outside image {img.shape[:2]}")
    return img[y:y + h, x:x + w]


_COLOR_FORMAT_CODES = {
    "gray": "COLOR_BGR2GRAY", "grey": "COLOR_BGR2GRAY",
    "rgb": "COLOR_BGR2RGB", "hsv": "COLOR_BGR2HSV",
    "luv": "COLOR_BGR2LUV", "lab": "COLOR_BGR2LAB",
    "yuv": "COLOR_BGR2YUV",
}


def _op_color_format(img: np.ndarray, p: Mapping) -> np.ndarray:
    fmt = p["format"]
    if fmt not in _COLOR_FORMAT_CODES:
        raise ValueError(f"unknown color format {fmt!r}; "
                         f"one of {sorted(_COLOR_FORMAT_CODES)}")
    cv2 = _cv2()
    out = cv2.cvtColor(img, getattr(cv2, _COLOR_FORMAT_CODES[fmt]))
    return out if out.ndim == 3 else out[:, :, None]


def _op_flip(img: np.ndarray, p: Mapping) -> np.ndarray:
    # OpenCV's flip codes: 1 = left-right, 0 = up-down, -1 = both
    code = int(p.get("flip_code", 1))
    if code == 1:
        return img[:, ::-1]
    if code == 0:
        return img[::-1]
    return img[::-1, ::-1]


def _op_blur(img: np.ndarray, p: Mapping) -> np.ndarray:
    return _cv2().blur(img, (int(p["height"]), int(p["width"])))


def _op_threshold(img: np.ndarray, p: Mapping) -> np.ndarray:
    cv2 = _cv2()
    _, out = cv2.threshold(img, float(p["threshold"]), float(p["max_val"]),
                           getattr(cv2, "THRESH_" +
                                   p.get("type", "binary").upper()))
    return out if out.ndim == 3 else out[:, :, None]


def _op_gaussian_kernel(img: np.ndarray, p: Mapping) -> np.ndarray:
    k = int(p["aperture_size"])
    return _cv2().GaussianBlur(img, (k, k), float(p.get("sigma", 0)))


OPS: dict[str, Callable[[np.ndarray, Mapping], np.ndarray]] = {
    "resize": _op_resize,
    "crop": _op_crop,
    "color_format": _op_color_format,
    "flip": _op_flip,
    "blur": _op_blur,
    "threshold": _op_threshold,
    "gaussian_kernel": _op_gaussian_kernel,
}


# ---- device steps: (params on the device, [B,H,W,C] uint8) -> tensor.
#      Each computes its host op's arithmetic on the batch ----

DEVICE_OPS = frozenset({"resize", "crop", "flip"})


def _device_resize_step(h: int, w: int, oh: int, ow: int
                        ) -> tuple[Callable, tuple]:
    """Batched align-corners bilinear resize: the taps and weights of
    :func:`imgops.bilinear_taps` (the step's params), gathered by
    ``index_select``, blended in float32 in the host op's order and
    rounded by truncating ``v + 0.5``. At the image's own size every
    weight is 0, so the step is the identity, bit for bit, and skips the
    gathers."""
    if (h, w) == (oh, ow):
        return (lambda p, img: img), ()
    y0, y1, wy = imgops.bilinear_taps(h, oh)
    x0, x1, wx = imgops.bilinear_taps(w, ow)
    params = (y0, y1, x0, x1, wy.reshape(1, oh, 1, 1),
              wx.reshape(1, 1, ow, 1))

    def step(p: tuple, img: torch.Tensor) -> torch.Tensor:
        y0, y1, x0, x1, wy, wx = p
        rows0 = img.index_select(1, y0)
        rows1 = img.index_select(1, y1)
        v00 = rows0.index_select(2, x0).float()
        v01 = rows0.index_select(2, x1).float()
        v10 = rows1.index_select(2, x0).float()
        v11 = rows1.index_select(2, x1).float()
        v = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
             + v10 * wy * (1 - wx) + v11 * wy * wx)
        return (v + 0.5).to(torch.uint8)

    return step, params


def _device_flip_step(code: int) -> tuple[Callable, tuple]:
    dims = {1: (2,), 0: (1,)}.get(code, (1, 2))

    def step(p: tuple, img: torch.Tensor) -> torch.Tensor:
        return torch.flip(img, dims)

    return step, ()


def _device_crop_step(x: int, y: int, ch: int, cw: int
                      ) -> tuple[Callable, tuple]:
    # Python slice semantics, as the host op's (a negative start counts
    # from the end)
    def step(p: tuple, img: torch.Tensor) -> torch.Tensor:
        return img[:, y:y + ch, x:x + cw]

    return step, ()


class ImageTransformer(Transformer, DeviceStage, HasInputCol, HasOutputCol,
                       HasDevice):
    """Applies an ordered list of image ops per row.

    Ops are dicts: ``{"op": "resize", "height": 32, "width": 32}``.
    Accepts image-struct columns, HWC arrays or encoded bytes (decoded by
    OpenCV)."""

    input_col = Param(default="image", doc="input image column", type_=str)
    output_col = Param(default="image", doc="output image column", type_=str)
    ops = Param(default=None, doc="ordered list of image op dicts",
                type_=(list, tuple))

    def _add(self, **op: Any) -> "ImageTransformer":
        self.set(ops=(list(self.ops or []) + [op]))
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add(op="resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int,
             width: int) -> "ImageTransformer":
        return self._add(op="crop", x=x, y=y, height=height, width=width)

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add(op="color_format", format=format)

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add(op="flip", flip_code=flip_code)

    def blur(self, height: int, width: int) -> "ImageTransformer":
        return self._add(op="blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float,
                  type: str = "binary") -> "ImageTransformer":
        return self._add(op="threshold", threshold=threshold,
                         max_val=max_val, type=type)

    def gaussian_kernel(self, aperture_size: int,
                        sigma: float = 0.0) -> "ImageTransformer":
        return self._add(op="gaussian_kernel", aperture_size=aperture_size,
                         sigma=sigma)

    def _process_one(self, value: Any) -> dict | None:
        if value is None:
            return None
        if isinstance(value, dict):
            img = np.asarray(value["data"])
            path = value.get("path", "")
        elif isinstance(value, (bytes, bytearray)):
            cv2 = _cv2()
            img = cv2.imdecode(np.frombuffer(bytes(value), np.uint8),
                               cv2.IMREAD_UNCHANGED)
            path = ""
            if img is None:
                return None
        else:
            img = np.asarray(value, dtype=np.uint8)
            path = ""
        for op in self.ops or []:
            img = OPS[op["op"]](img, op)
        return make_image(path, img)

    def transform(self, table: DataTable) -> DataTable:
        for op in self.ops or []:
            if op.get("op") not in OPS:
                raise ValueError(f"unknown image op {op.get('op')!r}; "
                                 f"available: {sorted(OPS)}")
        col = table[self.input_col]
        if len(col) > 1 and IMAGE_THREADS > 1:
            with ThreadPoolExecutor(max_workers=IMAGE_THREADS) as pool:
                out = list(pool.map(self._process_one, col))
        else:
            out = [self._process_one(v) for v in col]
        table = table.with_column(self.output_col, out)
        return mark_image_column(table, self.output_col)

    def device_fn(self, meta: ArrayMeta) -> DeviceOp | None:
        """The op list on a uint8 ``[B,H,W,C]`` batch. Only resize, crop and
        flip qualify; any other op declines, as does a crop outside the
        image (so the host path raises its per-row error)."""
        if not meta.is_image or meta.dtype != "uint8" or len(meta.shape) != 3:
            return None
        h, w, c = meta.shape
        steps, params = [], []
        for op in self.ops or []:
            kind = op.get("op")
            if kind not in DEVICE_OPS:
                return None
            if kind == "resize":
                oh, ow = int(op["height"]), int(op["width"])
                step = _device_resize_step(h, w, oh, ow)
                h, w = oh, ow
            elif kind == "crop":
                x, y = int(op.get("x", 0)), int(op.get("y", 0))
                ch, cw = int(op["height"]), int(op["width"])
                if y + ch > h or x + cw > w:
                    return None
                step = _device_crop_step(x, y, ch, cw)
                h, w = ch, cw
            else:
                step = _device_flip_step(int(op.get("flip_code", 1)))
            steps.append(step[0])
            params.append(step[1])

        def fn(all_params: list, img: torch.Tensor) -> torch.Tensor:
            for step, p in zip(steps, all_params):
                img = step(p, img)
            return img

        return DeviceOp(fn, ArrayMeta((h, w, c), "uint8", is_image=True),
                        params=params)

    def device_emit(self, table: DataTable, values: Any, meta: ArrayMeta,
                    ctx: dict) -> DataTable:
        paths = ctx.get("paths") or [""] * len(values)
        out = [make_image(p, v) for p, v in zip(paths, values)]
        table = table.with_column(self.output_col, out)
        return mark_image_column(table, self.output_col)


class UnrollImage(Transformer, DeviceStage, HasInputCol, HasOutputCol,
                  HasDevice):
    """Image struct → flat CHW float32 vector, ``px · scale + offset``."""

    input_col = Param(default="image", doc="input image column", type_=str)
    output_col = Param(default="features", doc="output vector column",
                       type_=str)
    scale = Param(default=1.0, doc="multiply pixels by this", type_=float)
    offset = Param(default=0.0, doc="then add this", type_=float)
    to_rgb = Param(default=False, doc="swap BGR→RGB while unrolling",
                   type_=bool)

    def transform(self, table: DataTable) -> DataTable:
        col = table[self.input_col]
        datas = [None if v is None else np.asarray(v["data"]) for v in col]
        datas = [d[:, :, None] if d is not None and d.ndim == 2 else d
                 for d in datas]
        shapes = {d.shape for d in datas if d is not None}
        if len(shapes) == 1 and all(d is not None for d in datas):
            # one pass over the whole stack
            out = imgops.unroll_batch(np.stack(datas), to_rgb=self.to_rgb,
                                      scale=self.scale, offset=self.offset)
            vecs: list = list(out.reshape(len(datas), -1))
        else:
            vecs = [None if d is None else
                    imgops.unroll(d, to_rgb=self.to_rgb, scale=self.scale,
                                  offset=self.offset).reshape(-1)
                    for d in datas]
        return table.with_column(self.output_col, vecs)

    def device_fn(self, meta: ArrayMeta) -> DeviceOp | None:
        """The host unroll's ``float(px) · scale + offset`` on the CHW view
        of the batch."""
        if not meta.is_image or len(meta.shape) != 3:
            return None
        h, w, c = meta.shape
        scale = float(np.float32(self.scale))
        offset = float(np.float32(self.offset))
        to_rgb = bool(self.to_rgb) and c == 3

        def fn(params: tuple, x: torch.Tensor) -> torch.Tensor:
            xf = x.float()
            if to_rgb:
                xf = torch.flip(xf, (3,))
            chw = xf.permute(0, 3, 1, 2)
            return (chw * scale + offset).reshape(x.shape[0], c * h * w)

        return DeviceOp(fn, ArrayMeta((c * h * w,), "float32"))
