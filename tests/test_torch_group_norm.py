"""The port's GroupNorm (mmlspark_tpu_torch/ops/group_norm.py) against the
JAX package's.

On the CPU the port's ``group_norm`` takes its plain PyTorch version; it
is held against the JAX package's ``group_norm_reference`` (XLA) and its
``group_norm`` (the Pallas kernel, in interpret mode on the CPU, as
``tests/test_ops.py`` runs it), on numpy-seeded inputs.

Tolerances:

* float32 inputs of unit spread: ``rtol=atol=1e-5``. Every side takes
  float32 statistics with the centred variance; they differ only in the
  order of the sums (measured up to 2e-6).
* mean 200, spread 0.02: ``atol=1e-2`` on the output (scale and bias of
  unit spread). An f32 step at 200 is 1.5e-5, 7.6e-4 of the spread, and a
  group's sum of 256 such values reaches 5e4, where an f32 step is 4e-3:
  the two sides sum in different orders, so their means differ by about
  1e-4, 5e-3 of the spread (measured 5.0e-3). Against a float64 oracle
  the port keeps the JAX package's own pin for this case, 5e-3 at unit
  scale.
* bfloat16: ``rtol=atol=8e-3``, one bfloat16 step (2^-8 relative): both
  sides compute in float32 and round once to bfloat16, so a value whose
  f32 result sits at a rounding boundary may land one step apart.
* gradients (float32): ``rtol=atol=1e-4``: the backward of the same
  function through two autodiff systems, each summing over H·W in its
  own order.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import group_norm as tgn

try:
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.ops.group_norm import group_norm as jax_group_norm
    from mmlspark_tpu.ops.group_norm import (
        group_norm_reference as jax_group_norm_reference,
    )
except ImportError:  # a machine with the card but no JAX: cuda tests only
    jax = None


@pytest.fixture(autouse=True)
def _needs_jax_unless_cuda(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX: holds the port against the JAX package")


F32_TOL = dict(rtol=1e-5, atol=1e-5)
OFFSET_TOL = dict(rtol=0, atol=1e-2)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# name -> (shape NHWC, groups, center, spread)
CASES = {
    "unit": ((2, 6, 5, 16), 4, 0.0, 1.0),
    "one_channel_per_group": ((2, 4, 4, 8), 8, 0.0, 1.0),
    "single_group": ((1, 3, 7, 12), 1, 0.5, 2.0),
    "mean_200_spread_0.02": ((2, 8, 8, 32), 8, 200.0, 0.02),
}


def _inputs(case, seed=0):
    shape, groups, center, spread = CASES[case]
    r = np.random.default_rng(seed)
    x = r.normal(center, spread, shape).astype(np.float32)
    scale = r.normal(size=shape[-1]).astype(np.float32)
    bias = r.normal(size=shape[-1]).astype(np.float32)
    return x, scale, bias, groups


def _tol(case, dtype):
    if dtype == "bf16":
        return BF16_TOL
    return OFFSET_TOL if CASES[case][2] > 100 else F32_TOL


def _port(x, scale, bias, groups, relu, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = tgn.group_norm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(scale), torch.from_numpy(bias),
                         groups, relu=relu)
    assert out.dtype == tdt
    return out.float().numpy()


def _jax(fn, x, scale, bias, groups, relu, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = fn(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
             groups, relu=relu)
    assert out.dtype == jdt
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_matches_jax_group_norm(jax_fn, case, relu, dtype):
    x, scale, bias, groups = _inputs(case)
    if dtype == "bf16":
        # both sides see the same bf16-rounded inputs
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    fn = jax_group_norm_reference if jax_fn == "reference" \
        else jax_group_norm
    got = _port(x, scale, bias, groups, relu, dtype)
    want = _jax(fn, x, scale, bias, groups, relu, dtype)
    np.testing.assert_allclose(got, want, **_tol(case, dtype))
    if relu:
        assert (got >= 0).all()


@pytest.mark.parametrize("seed", [0, 4])
def test_centred_variance_tracks_a_float64_oracle(seed):
    """At mean 200 and spread 0.02 the one-pass E[x²]−E[x]² is noise; the
    plain version stays within the JAX package's pin of 5e-3 of a float64
    oracle on the same f32 inputs."""
    x, _, _, groups = _inputs("mean_200_spread_0.02", seed=seed)
    n, h, w, c = x.shape
    out = tgn.group_norm(torch.from_numpy(x), torch.ones(c),
                         torch.zeros(c), groups).numpy()
    xf = x.astype(np.float64).reshape(n, h * w, groups, c // groups)
    mean = xf.mean(axis=(1, 3), keepdims=True)
    var = ((xf - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    want = ((xf - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    assert np.abs(out - want).max() < 5e-3


@pytest.mark.parametrize("relu", [False, True])
def test_gradients_match_jax_vjp(relu):
    x, scale, bias, groups = _inputs("unit", seed=2)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: jax_group_norm(a, s, b, groups,
                                                    relu=relu),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    inputs = [torch.from_numpy(a).requires_grad_()
              for a in (x, scale, bias)]
    out = tgn.group_norm(*inputs, groups, relu=relu)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)


def test_kernel_autograd_function_differentiates_the_plain_version(
        monkeypatch):
    """The kernel route's ``autograd.Function``: its backward recomputes
    the plain version and differentiates it. The forward is replaced by
    the plain version here (the kernel runs only on a card), so its
    gradients must equal plain autograd's exactly."""
    monkeypatch.setattr(tgn, "_group_norm_cuda", tgn.group_norm_reference)
    x, scale, bias, groups = _inputs("unit", seed=5)
    g = torch.from_numpy(
        np.random.default_rng(6).normal(size=x.shape).astype(np.float32))
    grads = []
    for route in ("function", "plain"):
        inputs = [torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias)]
        if route == "function":
            out = tgn._GroupNormKernel.apply(*inputs, groups, 1e-6, True)
        else:
            out = tgn.group_norm_reference(*inputs, groups, 1e-6, True)
        grads.append(torch.autograd.grad(out, inputs, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("c,groups", [(12, 5), (16, 0), (8, 16)])
def test_groups_that_do_not_divide_channels_raise(c, groups):
    x = torch.zeros(1, 2, 2, c)
    with pytest.raises(ValueError, match="not divisible"):
        tgn.group_norm(x, torch.ones(c), torch.zeros(c), groups)
    with pytest.raises(ValueError, match="not divisible"):
        tgn.group_norm_reference(x, torch.ones(c), torch.zeros(c), groups)


@pytest.mark.parametrize("impl", ["pallas", "xla", "triton", ""])
def test_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="unknown group_norm impl"):
        tgn.group_norm(torch.zeros(1, 2, 2, 4), torch.ones(4),
                       torch.zeros(4), 2, impl=impl)


def test_cuda_impl_on_cpu_tensors_raises_and_launches_nothing():
    before = tgn.launches
    args = (torch.zeros(1, 2, 2, 4), torch.ones(4), torch.zeros(4), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgn.group_norm(*args, impl="cuda")
    tgn.group_norm(*args)  # the plain version on CPU tensors
    assert tgn.launches == before


@pytest.mark.parametrize("n,hw,c", [(64, 112 * 112, 64), (64, 49, 2048),
                                    (1, 49, 2048), (3, 35, 48)])
def test_kernel_plan_covers_every_row(n, hw, c):
    p = tgn.plan(n, hw, c)
    assert p["tile_rows"] * (p["ntiles"] - 1) < hw <= \
        p["tile_rows"] * p["ntiles"]
    assert p["ct"] * p["rt"] <= 256 and p["apply_blocks"] >= 1


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at ResNet-50
    shapes and the edge cases. Tolerance: float32 outputs 1e-4 (f32
    statistics summed in another order); bfloat16 one step of the output
    (both round one float32 result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, groups, dtype, center, spread in [
            ((8, 112, 112, 64), 32, torch.bfloat16, 0.0, 1.0),
            ((8, 7, 7, 2048), 32, torch.float32, 0.0, 1.0),
            ((2, 8, 8, 32), 8, torch.float32, 200.0, 0.02),
            ((1, 13, 11, 64), 32, torch.bfloat16, 0.0, 1.0)]:
        x = (center + spread * torch.randn(shape, generator=gen,
                                           device=dev)).to(dtype)
        scale = torch.randn(shape[-1], generator=gen, device=dev)
        bias = torch.randn(shape[-1], generator=gen, device=dev)
        before = tgn.launches
        got = tgn.group_norm(x, scale, bias, groups, relu=True)
        torch.cuda.synchronize()
        assert tgn.launches == before + 1
        want = tgn.group_norm(x, scale, bias, groups, relu=True,
                              impl="torch")
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol if spread >= 1 else 5e-3)
