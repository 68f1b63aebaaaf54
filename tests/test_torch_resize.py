"""The port's fused crop → resize → scale (mmlspark_tpu_torch/ops/resize.py)
against the JAX package's three implementations.

On the CPU the port's ``fused_resize_norm`` takes its plain PyTorch
version. Every implementation uses the same f32 taps and weights
(``_grids``, copied into the port):

* against the numpy oracle ``fused_resize_norm_host``: EXACT. Both run
  the same float32 products and left-associated sums, each rounded on its
  own;
* against the XLA reference and the Pallas kernel (interpret mode, as
  ``tests/test_train_preprocess.py`` runs it): ``maxulp=2``, the JAX
  package's own pin between its XLA path and its numpy oracle, since XLA
  contracts the four-tap blend into FMAs.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import resize as trs

try:
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.ops.pallas import resize as jrs
except ImportError:  # a machine with the card but no JAX: cuda tests only
    jax = None


@pytest.fixture(autouse=True)
def _needs_jax_unless_cuda(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX: holds the port against the JAX package")


SCALE = 1 / 255.0

# name -> (N, H, W, C, crop, out_hw, offsets (oy, ox) or None = random)
CASES = {
    "slice_geometry_small": (3, 24, 24, 3, (20, 20), (16, 16), None),
    "offsets_zero_and_max": (2, 24, 20, 3, (18, 15), (12, 10),
                             ((0, 6), (0, 5))),
    "crop_is_source": (2, 12, 12, 3, (12, 12), (9, 7), ((0, 0), (0, 0))),
    "one_output_row": (2, 16, 16, 3, (10, 12), (1, 8), None),
    "one_channel_non_square": (2, 20, 16, 1, (14, 9), (6, 11), None),
    "upsample": (2, 10, 10, 3, (6, 6), (13, 13), None),
}


def _inputs(case, seed=0):
    n, h, w, c, crop, out_hw, offs = CASES[case]
    r = np.random.default_rng(seed)
    x = r.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    if offs is None:
        oy = r.integers(0, h - crop[0] + 1, n).astype(np.int32)
        ox = r.integers(0, w - crop[1] + 1, n).astype(np.int32)
    else:
        oy, ox = (np.asarray(o, np.int32) for o in offs)
    return x, oy, ox, crop, out_hw


def _port(x, oy, ox, crop, out_hw, impl="auto"):
    return trs.fused_resize_norm(torch.from_numpy(x), torch.from_numpy(oy),
                                 torch.from_numpy(ox), crop, out_hw, SCALE,
                                 impl=impl).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_equals_the_numpy_oracle_exactly(case):
    x, oy, ox, crop, out_hw = _inputs(case)
    got = _port(x, oy, ox, crop, out_hw)
    want = jrs.fused_resize_norm_host(x, oy, ox, crop, out_hw, SCALE)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_matches_jax_device_paths(jax_impl, case):
    x, oy, ox, crop, out_hw = _inputs(case)
    got = _port(x, oy, ox, crop, out_hw)
    want = np.asarray(jrs.fused_resize_norm(
        jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox), crop, out_hw,
        SCALE, impl=jax_impl))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_out_of_range_offsets_clamp_as_dynamic_slice_does():
    """Offsets are placed as ``jax.lax.dynamic_slice`` places a start: a
    negative start counts from the end of its axis, then the start is
    clamped into the image. The JAX XLA reference agrees."""
    x, _, _, crop, out_hw = _inputs("offsets_zero_and_max", seed=3)
    oy = np.asarray([-4, 50], np.int32)
    ox = np.asarray([9, -30], np.int32)
    got = _port(x, oy, ox, crop, out_hw)
    h, w = x.shape[1:3]
    clamped = (np.clip(np.where(oy < 0, oy + h, oy), 0, h - crop[0]),
               np.clip(np.where(ox < 0, ox + w, ox), 0, w - crop[1]))
    assert clamped[0].tolist() == [6, 6] and clamped[1].tolist() == [5, 0]
    np.testing.assert_array_equal(
        got, _port(x, *(c.astype(np.int32) for c in clamped), crop, out_hw))
    want = np.asarray(jrs.fused_resize_norm_reference(
        jnp.asarray(x), jnp.asarray(oy), jnp.asarray(ox), crop, out_hw,
        SCALE))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_identity_window_is_the_plain_cast():
    x, _, _, _, _ = _inputs("crop_is_source")
    z = np.zeros(len(x), np.int32)
    got = _port(x, z, z, x.shape[1:3], x.shape[1:3])
    np.testing.assert_array_equal(got, x.astype(np.float32)
                                  * np.float32(SCALE))


def test_grids_are_the_jax_packages():
    for geom in [(240, 240, 224, 224), (10, 12, 1, 8), (6, 6, 13, 13)]:
        for a, b in zip(trs._grids(*geom), jrs._grids(*geom)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bad_inputs_raise():
    x = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="larger than the source"):
        trs.fused_resize_norm(x, z, z, (16, 8), (4, 4), 1.0)
    with pytest.raises(ValueError, match="unknown fused_resize_norm impl"):
        trs.fused_resize_norm(x, z, z, (8, 8), (4, 4), 1.0, impl="pallas")
    with pytest.raises(TypeError, match="uint8"):
        trs.fused_resize_norm(x.float(), z, z, (8, 8), (4, 4), 1.0)
    with pytest.raises(ValueError, match=r"\[N\]"):
        trs.fused_resize_norm(x, z[:1], z, (8, 8), (4, 4), 1.0)


def test_cuda_impl_on_cpu_tensors_raises_and_launches_nothing():
    x = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    before = trs.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        trs.fused_resize_norm(x, z, z, (8, 8), (4, 4), 1.0, impl="cuda")
    trs.fused_resize_norm(x, z, z, (6, 6), (4, 4), 1.0)
    assert trs.launches == before


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version():
    """The CUDA kernel against its plain version on the card: the same
    float32 operations in the same order, so EXACT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, h, w, c, crop, out_hw in [(64, 256, 256, 3, (240, 240), (224, 224)),
                                     (3, 20, 16, 1, (14, 9), (1, 11))]:
        x = torch.randint(0, 256, (n, h, w, c), generator=gen, device=dev,
                          dtype=torch.uint8)
        oy = torch.randint(0, h - crop[0] + 1, (n,), generator=gen,
                           device=dev, dtype=torch.int32)
        ox = torch.randint(0, w - crop[1] + 1, (n,), generator=gen,
                           device=dev, dtype=torch.int32)
        before = trs.launches
        got = trs.fused_resize_norm(x, oy, ox, crop, out_hw, SCALE)
        torch.cuda.synchronize()
        assert trs.launches == before + 1
        want = trs.fused_resize_norm(x, oy, ox, crop, out_hw, SCALE,
                                     impl="torch")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
