"""The port's on-device preprocessing (mmlspark_tpu_torch/ops/augment.py,
mmlspark_tpu_torch/train/preprocess.py) against the JAX package's.

``jax.random`` and ``torch.Generator`` give other numbers from one seed,
so the draws are handed over: either made with numpy and given to the
port's ops and to the JAX package's numpy oracles (``host_crop``,
``host_brightness``, ``host_contrast``), or taken from the JAX key
schedule of ``augment_batch`` and given to the port's ``augment.apply``.

Tolerances:

* crops, flips and brightness: EXACT. The same gathers and the same one
  float32 add on both sides;
* contrast: ``rtol=atol=1e-6``. Both take the per-sample mean in float32
  over H·W·C values and sum in other orders (numpy pairwise, XLA and
  PyTorch their own), so the mean may differ in its last bit;
* the geometry stage against the JAX package's ``fused_resize_norm``
  (XLA): ``maxulp=2``, the JAX package's own pin, since XLA contracts the
  four-tap blend into FMAs.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mmlspark_tpu.ops import augment as jaug  # noqa: E402
from mmlspark_tpu.ops.pallas.resize import (  # noqa: E402
    fused_resize_norm as jax_fused_resize_norm,
)
from mmlspark_tpu.train import preprocess as jpp  # noqa: E402
from mmlspark_tpu_torch.ops import augment as taug  # noqa: E402
from mmlspark_tpu_torch.train import preprocess as tpp  # noqa: E402

CONTRAST_TOL = dict(rtol=1e-6, atol=1e-6)


def _batch(n=4, h=10, w=9, c=3, seed=0):
    return np.random.default_rng(seed).random((n, h, w, c)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("pad", [1, 3])
def test_random_crop_equals_host_crop(pad):
    x = _batch(seed=pad)
    r = np.random.default_rng(10 + pad)
    oy = r.integers(0, 2 * pad + 1, len(x))
    ox = r.integers(0, 2 * pad + 1, len(x))
    oy[0], ox[0] = 0, 2 * pad
    got = taug.random_crop(_t(x), pad, _t(oy), _t(ox)).numpy()
    np.testing.assert_array_equal(got, jaug.host_crop(x, pad, oy, ox))


@pytest.mark.parametrize("axis", ["lr", "ud"])
def test_flips_follow_their_coins(axis):
    x = _batch(seed=2)
    coin = np.asarray([True, False, True, False])
    flip = taug.flip_lr if axis == "lr" else taug.flip_ud
    got = flip(_t(x), _t(coin)).numpy()
    flipped = x[:, :, ::-1] if axis == "lr" else x[:, ::-1]
    want = np.where(coin[:, None, None, None], flipped, x)
    np.testing.assert_array_equal(got, want)


def test_brightness_equals_host_brightness():
    x = _batch(seed=3)
    shift = np.random.default_rng(4).uniform(-0.2, 0.2, len(x)).astype(
        np.float32)
    got = taug.brightness(_t(x), _t(shift)).numpy()
    np.testing.assert_array_equal(got, jaug.host_brightness(x, shift))


def test_contrast_equals_host_contrast():
    x = _batch(seed=5)
    factor = np.random.default_rng(6).uniform(0.7, 1.3, len(x)).astype(
        np.float32)
    got = taug.contrast(_t(x), _t(factor)).numpy()
    np.testing.assert_allclose(got, jaug.host_contrast(x, factor),
                               **CONTRAST_TOL)


def _jax_draws(key, n, pad, brightness, contrast):
    """The draws ``augment_batch`` makes from ``key``, by its key
    schedule (``split(key, 5)``, one key per stage)."""
    keys = jax.random.split(key, 5)
    ky, kx = jax.random.split(keys[0])
    lo, hi = contrast
    return taug.Draws(
        crop_oy=_t(np.asarray(jax.random.randint(ky, (n,), 0, 2 * pad + 1))),
        crop_ox=_t(np.asarray(jax.random.randint(kx, (n,), 0, 2 * pad + 1))),
        flip_lr=_t(np.asarray(jax.random.bernoulli(keys[1], 0.5, (n,)))),
        flip_ud=_t(np.asarray(jax.random.bernoulli(keys[2], 0.5, (n,)))),
        brightness=_t(np.asarray(jax.random.uniform(
            keys[3], (n, 1, 1, 1), minval=-brightness,
            maxval=brightness)).reshape(n)),
        contrast=_t(np.asarray(jax.random.uniform(
            keys[4], (n, 1, 1, 1), minval=lo, maxval=hi)).reshape(n)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_with_the_jax_draws_equals_augment_batch(seed):
    """Every stage in the JAX package's order: the port's ``apply`` fed
    the draws of ``augment_batch``'s key schedule gives its output."""
    x = _batch(n=6, h=12, w=12, seed=seed)
    key = jax.random.PRNGKey(seed)
    pad, bright, con = 2, 0.1, (0.8, 1.2)
    want = np.asarray(jaug.augment_batch(
        key, jnp.asarray(x), flip_lr=True, flip_ud=True, crop_pad=pad,
        brightness=bright, contrast=con))
    got = taug.apply(_t(x), _jax_draws(key, len(x), pad, bright, con),
                     crop_pad=pad).numpy()
    np.testing.assert_allclose(got, want, **CONTRAST_TOL)


def test_draw_respects_the_spec_and_its_ranges():
    spec = tpp.DevicePreprocess(crop_pad=3, flip_lr=True, brightness=0.25,
                                contrast=(0.5, 0.75))
    gen = torch.Generator().manual_seed(0)
    d = taug.draw(gen, 256, spec)
    for o in (d.crop_oy, d.crop_ox):
        assert o.min() >= 0 and o.max() <= 6 and set(o.tolist()) == set(
            range(7))
    assert d.flip_lr.dtype == torch.bool and 0 < d.flip_lr.sum() < 256
    assert d.flip_ud is None
    assert d.brightness.abs().max() <= 0.25
    assert d.contrast.min() >= 0.5 and d.contrast.max() <= 0.75
    off = taug.draw(gen, 4, tpp.DevicePreprocess())
    assert all(v is None for v in vars(off).values())


def test_augment_apply_refuses_integer_batches():
    with pytest.raises(TypeError, match="float"):
        taug.apply(torch.zeros(1, 4, 4, 3, dtype=torch.uint8), taug.Draws())


BAD_SPECS = [
    dict(resize=(0, 32)), dict(resize=(32,)), dict(src_crop=(8, -1)),
    dict(contrast=(1.2, 0.8)), dict(contrast=(-0.1, 1.0)),
    dict(crop_pad=-1), dict(std=(0.5, 0.0, 0.5)), dict(impl="tpu"),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=[str(k) for k in BAD_SPECS])
def test_bad_specs_raise_the_jax_packages_exception(kw):
    with pytest.raises(Exception) as want:
        jpp.DevicePreprocess(**kw)
    with pytest.raises(want.type):
        tpp.DevicePreprocess(**kw)


def test_impl_takes_the_ports_vocabulary():
    for impl in ("auto", "cuda", "torch"):
        assert tpp.DevicePreprocess(impl=impl).impl == impl
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="impl"):
            tpp.DevicePreprocess(impl=impl)


def test_parse_takes_specs_dicts_and_none():
    spec = tpp.DevicePreprocess.parse({"resize": [32, 32], "crop_pad": 4})
    assert spec.resize == (32, 32) and spec.crop_pad == 4
    assert tpp.DevicePreprocess.parse(spec) is spec
    assert tpp.DevicePreprocess.parse(None) is None
    with pytest.raises(TypeError, match="DevicePreprocess"):
        tpp.DevicePreprocess.parse("resize=32")


GEOMETRIES = [
    (dict(src_crop=(28, 28), resize=(16, 16), crop_pad=2), (32, 32, 3)),
    (dict(), (9, 7, 1)),
    (dict(resize=(24, 20), mean=(0.5,), std=(0.2,)), (40, 36, 3)),
    (dict(src_crop=(240, 240), resize=(224, 224)), (256, 256, 3)),
    (dict(src_crop=(40, 40)), (32, 32, 3)),
    (dict(crop_pad=9), (8, 8, 3)),
    (dict(mean=(0.5, 0.5)), (8, 8, 3)),
    (dict(), (8, 8)),
]


@pytest.mark.parametrize("kw,shape", GEOMETRIES,
                         ids=[f"{k}-{s}" for k, s in GEOMETRIES])
def test_out_shape_agrees_with_the_jax_package(kw, shape):
    try:
        want = jpp.DevicePreprocess(**kw).out_shape(shape)
    except ValueError:
        with pytest.raises(ValueError):
            tpp.DevicePreprocess(**kw).out_shape(shape)
        return
    assert tpp.DevicePreprocess(**kw).out_shape(shape) == want


def test_deterministic_geometry_matches_the_jax_apply():
    """A spec with no stochastic stage: resize 40² uint8 to 32², scale,
    standardise. The JAX ``apply`` runs its XLA geometry path."""
    spec = dict(resize=(32, 32), mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3))
    x = np.random.default_rng(7).integers(0, 256, (3, 40, 40, 3),
                                          dtype=np.uint8)
    want = np.asarray(jpp.apply(jpp.DevicePreprocess(**spec, impl="xla"),
                                jax.random.PRNGKey(0), jnp.asarray(x),
                                1 / 255.0))
    got = tpp.apply(tpp.DevicePreprocess(**spec),
                    tpp.step_generator(0, 0, "cpu"), _t(x), 1 / 255.0)
    assert not got.requires_grad
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_geometry_alone_matches_the_jax_fused_pass():
    x = np.random.default_rng(8).integers(0, 256, (4, 30, 26, 3),
                                          dtype=np.uint8)
    oy = np.asarray([0, 6, 3, 2], np.int32)
    ox = np.asarray([4, 0, 1, 4], np.int32)
    spec = tpp.DevicePreprocess(src_crop=(24, 22), resize=(16, 12))
    got = tpp.geometry_normalize(spec, _t(x), _t(oy), _t(ox), 1 / 255.0)
    want = np.asarray(jax_fused_resize_norm(
        jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox), (24, 22), (16, 12),
        1 / 255.0, impl="xla"))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_identity_geometry_is_the_plain_cast_and_launches_nothing():
    from mmlspark_tpu_torch.ops import resize as trs
    x = np.random.default_rng(9).integers(0, 256, (2, 8, 8, 3),
                                          dtype=np.uint8)
    before = trs.launches
    z = torch.zeros(2, dtype=torch.int32)
    got = tpp.geometry_normalize(tpp.DevicePreprocess(impl="cuda"), _t(x),
                                 z, z, 1 / 255.0)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.float32) * np.float32(1 / 255.0))
    assert trs.launches == before


def test_draws_replay_per_step_and_differ_across_steps():
    spec = tpp.DevicePreprocess(src_crop=(12, 12), resize=(8, 8),
                                crop_pad=2, flip_lr=True, brightness=0.2,
                                contrast=(0.8, 1.2))
    x = _t(np.random.default_rng(10).integers(0, 256, (8, 16, 16, 3),
                                              dtype=np.uint8))
    a = tpp.apply(spec, tpp.step_generator(3, 0, "cpu"), x, 1 / 255.0)
    b = tpp.apply(spec, tpp.step_generator(3, 0, "cpu"), x, 1 / 255.0)
    c = tpp.apply(spec, tpp.step_generator(3, 1, "cpu"), x, 1 / 255.0)
    d = tpp.apply(spec, tpp.step_generator(4, 0, "cpu"), x, 1 / 255.0)
    assert a.shape == (8, 8, 8, 3) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_geometry_draws_stay_inside_the_image():
    spec = tpp.DevicePreprocess(src_crop=(10, 7))
    x = torch.zeros(512, 12, 9, 1, dtype=torch.uint8)
    oy, ox = tpp.geometry_draws(torch.Generator().manual_seed(0), spec, x)
    assert oy.dtype == torch.int32 and set(oy.tolist()) == {0, 1, 2}
    assert set(ox.tolist()) == {0, 1, 2}


def test_float_input_skips_the_geometry_stage():
    spec = tpp.DevicePreprocess(resize=(4, 4), mean=(0.5,), std=(0.25,))
    x = _batch(n=2, h=6, w=6, c=1, seed=11)
    got = tpp.apply(spec, tpp.step_generator(0, 0, "cpu"), _t(x), 1 / 255.0)
    np.testing.assert_allclose(got.numpy(), (x - 0.5) / 0.25, rtol=1e-6,
                               atol=1e-6)
