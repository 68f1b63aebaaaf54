"""The port's image stages against the JAX package's, on the CPU.

The same numpy-seeded images go through ``mmlspark_tpu.stages.image`` and
``mmlspark_tpu_torch.stages.image``. Tolerances:

* crop, flip and unroll at scale 1 / offset 0 are indexing and exact
  integer arithmetic: bit for bit;
* resize: both sides compute the native library's align-corners bilinear
  in float32 in the same order and round by truncating ``v + 0.5``; the
  JAX device step and the native op agree only to one count (a compiler
  may contract the blend into FMAs, which moves a value sitting on a
  rounding edge), so resize is held to ``RESIZE_TOL`` = 1 count against
  both;
* unroll with a non-trivial scale and offset: ``px · s + o`` rounded
  once or twice (with or without an FMA) differs by at most one float32
  step of values below 1: ``UNROLL_TOL`` = 1e-6.
"""

import builtins

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.schema import make_image as jax_make_image
from mmlspark_tpu.core.stage import ArrayMeta as JaxArrayMeta
from mmlspark_tpu.data.table import DataTable as JaxTable
from mmlspark_tpu.native import imgops as jax_imgops
from mmlspark_tpu.stages import image as jax_image

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.schema import (
    find_unused_column_name, is_image_column, make_image,
    mark_image_column,
)
from mmlspark_tpu_torch.core.stage import ArrayMeta
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.native import imgops
from mmlspark_tpu_torch.stages.image import ImageTransformer, UnrollImage

RESIZE_TOL = 1
UNROLL_TOL = 1e-6


def _pixels(n, h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                                dtype=np.uint8)


def _tables(pixels):
    rows = [(f"p{k}", p) for k, p in enumerate(pixels)]
    return (DataTable({"image": [make_image(n, p) for n, p in rows]}),
            JaxTable({"image": [jax_make_image(n, p) for n, p in rows]}))


def _images(col):
    return np.stack([v["data"] for v in col]).astype(int)


def _jax_device(stage, meta, batch):
    op = stage.device_fn(JaxArrayMeta(meta.shape, meta.dtype, meta.is_image))
    return np.asarray(op.fn(op.params, batch))


def _port_device(stage, meta, batch):
    op = stage.device_fn(meta)
    with torch.inference_mode():
        out = op.fn(plan.place(op.params, torch.device("cpu")),
                    torch.from_numpy(batch))
    return out.numpy()


RESIZES = [((29, 23), (16, 12)), ((24, 18), (24, 18)), ((10, 7), (31, 40)),
           ((5, 5), (1, 1)), ((240, 320), (256, 256))]


@pytest.mark.parametrize("src,out", RESIZES)
def test_host_resize_matches_native_op(src, out):
    for c in (3, 1):
        img = _pixels(1, *src, c=c, seed=sum(src))[0]
        got = imgops.resize(img, *out).astype(int)
        want = jax_imgops.resize(img, *out).astype(int)
        assert got.shape == want.shape == out + (c,)
        assert np.abs(got - want).max() <= RESIZE_TOL


def test_host_resize_takes_a_2d_image():
    img = _pixels(1, 9, 7, c=1)[0, :, :, 0]
    assert np.abs(imgops.resize(img, 4, 5).astype(int)
                  - jax_imgops.resize(img, 4, 5).astype(int)).max() \
        <= RESIZE_TOL


@pytest.mark.parametrize("src,out", RESIZES[:4])
def test_device_resize_matches_jax_device_step_and_native_op(src, out):
    batch = _pixels(3, *src, seed=7)
    meta = ArrayMeta(src + (3,), "uint8", is_image=True)
    got = _port_device(ImageTransformer().resize(*out), meta, batch)
    want = _jax_device(jax_image.ImageTransformer().resize(*out), meta,
                       batch)
    native = np.stack([jax_imgops.resize(b, *out) for b in batch])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= RESIZE_TOL
    assert np.abs(got.astype(int) - native.astype(int)).max() <= RESIZE_TOL



@pytest.mark.parametrize("shape", [(24, 18), (1, 1)])
def test_device_resize_to_the_image_size_is_the_identity(shape):
    """At the image's own size every bilinear weight is 0: the step has no
    taps to place and returns the batch unchanged, bit for bit with the
    JAX device step and the native op."""
    from mmlspark_tpu_torch.stages.image import _device_resize_step
    assert _device_resize_step(*shape, *shape)[1] == ()
    batch = _pixels(2, *shape, seed=8)
    meta = ArrayMeta(shape + (3,), "uint8", is_image=True)
    got = _port_device(ImageTransformer().resize(*shape), meta, batch)
    np.testing.assert_array_equal(got, batch)
    np.testing.assert_array_equal(got, _jax_device(
        jax_image.ImageTransformer().resize(*shape), meta, batch))
    np.testing.assert_array_equal(
        got, np.stack([jax_imgops.resize(b, *shape) for b in batch]))

OP_LISTS = [
    [("crop", dict(x=2, y=3, height=16, width=12)), ("flip", dict(flip_code=-1))],
    [("flip", dict(flip_code=0)), ("flip", dict(flip_code=1))],
    [("crop", dict(x=-4, y=1, height=10, width=3))],
    [("resize", dict(height=30, width=20)),
     ("crop", dict(x=1, y=2, height=24, width=16)),
     ("flip", dict(flip_code=1))],
]


def _transformer(cls, ops):
    t = cls()
    for kind, kw in ops:
        getattr(t, kind)(**kw)
    return t


@pytest.mark.parametrize("ops", OP_LISTS)
def test_device_op_lists_match_jax(ops):
    """Crop (Python slice semantics, a negative start included) and flip
    bit for bit; resize within one count."""
    batch = _pixels(4, 24, 18, seed=3)
    meta = ArrayMeta((24, 18, 3), "uint8", is_image=True)
    port, jx = (_transformer(ImageTransformer, ops),
                _transformer(jax_image.ImageTransformer, ops))
    jmeta = jx.device_fn(JaxArrayMeta((24, 18, 3), "uint8", True)).out_meta
    assert port.device_fn(meta).out_meta == ArrayMeta(
        jmeta.shape, jmeta.dtype, jmeta.is_image)
    got = _port_device(port, meta, batch).astype(int)
    want = _jax_device(jx, meta, batch).astype(int)
    tol = RESIZE_TOL if any(k == "resize" for k, _ in ops) else 0
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("ops", OP_LISTS)
def test_host_transform_matches_jax(ops):
    table, jtable = _tables(_pixels(5, 24, 18, seed=4))
    got = _transformer(ImageTransformer, ops).transform(table)
    want = _transformer(jax_image.ImageTransformer, ops).transform(jtable)
    tol = RESIZE_TOL if any(k == "resize" for k, _ in ops) else 0
    assert np.abs(_images(got["image"]) - _images(want["image"])).max() \
        <= tol
    assert [v["path"] for v in got["image"]] == \
        [v["path"] for v in want["image"]]
    assert got.meta["image"] == {"is_image": True}


def test_device_declines_what_the_host_path_handles():
    meta = ArrayMeta((24, 18, 3), "uint8", is_image=True)
    for stage in (ImageTransformer().crop(0, 20, 10, 10),  # leaves the image
                  ImageTransformer().blur(3, 3),           # OpenCV op
                  ImageTransformer().color_format("gray")):
        assert stage.device_fn(meta) is None
    assert ImageTransformer().flip(1).device_fn(
        ArrayMeta((24, 18, 3), "float32", is_image=True)) is None
    assert UnrollImage().device_fn(ArrayMeta((12,), "float32")) is None


@pytest.mark.parametrize("op", [("blur", (3, 3)), ("threshold", (100, 255)),
                                ("gaussian_kernel", (3,)),
                                ("color_format", ("gray",))])
def test_opencv_ops_match_jax(op):
    pytest.importorskip("cv2")
    table, jtable = _tables(_pixels(3, 16, 12, seed=5))
    kind, args = op
    got = getattr(ImageTransformer(), kind)(*args).transform(table)
    want = getattr(jax_image.ImageTransformer(), kind)(*args).transform(
        jtable)
    np.testing.assert_array_equal(_images(got["image"]),
                                  _images(want["image"]))


def test_opencv_op_without_cv2_raises_a_clear_error(monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    table, _ = _tables(_pixels(1, 8, 8))
    with pytest.raises(ImportError, match="cv2 is not installed"):
        ImageTransformer().blur(3, 3).transform(table)
    # resize, crop and flip need no OpenCV
    out = ImageTransformer().resize(4, 4).crop(0, 0, 2, 2).flip(1) \
        .transform(table)
    assert out["image"][0]["data"].shape == (2, 2, 3)


@pytest.mark.parametrize("scale,offset,to_rgb,tol", [
    (1.0, 0.0, False, 0.0), (1 / 255.0, -0.5, True, UNROLL_TOL),
    (2.0, 1.0, False, 0.0)])
def test_unroll_matches_jax_host_and_device(scale, offset, to_rgb, tol):
    pixels = _pixels(4, 6, 5, seed=6)
    table, jtable = _tables(pixels)
    kw = dict(scale=scale, offset=offset, to_rgb=to_rgb)
    got = np.stack(UnrollImage(**kw).transform(table)["features"])
    want = np.stack(jax_image.UnrollImage(**kw).transform(jtable)
                    ["features"])
    assert got.dtype == np.float32 and got.shape == (4, 3 * 6 * 5)
    assert np.abs(got - want).max() <= tol
    meta = ArrayMeta((6, 5, 3), "uint8", is_image=True)
    dev = _port_device(UnrollImage(**kw), meta, pixels)
    jdev = _jax_device(jax_image.UnrollImage(**kw), meta, pixels)
    assert np.abs(dev - jdev).max() <= tol
    assert np.abs(dev - want).max() <= tol


def test_unroll_ragged_and_missing_rows_match_jax():
    r = np.random.default_rng(8)
    rows = [make_image("a", r.integers(0, 256, (4, 3, 3), dtype=np.uint8)),
            None,
            make_image("b", r.integers(0, 256, (5, 2, 1), dtype=np.uint8))]
    jrows = [None if v is None else jax_make_image(v["path"], v["data"])
             for v in rows]
    got = UnrollImage().transform(DataTable({"image": rows}))["features"]
    want = jax_image.UnrollImage().transform(JaxTable({"image": jrows}))[
        "features"]
    assert got[1] is None and want[1] is None
    for k in (0, 2):
        np.testing.assert_array_equal(got[k], want[k])


def test_image_schema_helpers():
    t = DataTable({"image": [None, make_image("x", np.zeros((2, 3)))],
                   "v": [1.0, 2.0]})
    assert is_image_column(t, "image") and not is_image_column(t, "v")
    assert t["image"][1]["data"].shape == (2, 3, 1)
    marked = mark_image_column(DataTable({"image": [b"raw"]}), "image")
    assert is_image_column(marked, "image")
    assert find_unused_column_name(t, "v") == "v_1"
    assert find_unused_column_name(t, "w") == "w"
