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
  function through two autodiff systems, or through autodiff and the
  closed form (``group_norm_backward_reference``), each summing over H·W
  in its own order (measured at most 7.6e-6 on gradients of magnitude
  up to 20). In bfloat16 ``dx`` is rounded once to bfloat16 on both
  sides: ``BF16_TOL`` (one step), ``dscale``/``dbias`` stay float32.
* gradients at mean 200, spread 0.02 (float32), ``OFFSET_GRAD_TOL``: the
  two sides' group means differ by a few float32 steps at 200 (one step,
  1.5e-5, is δ = 7.6e-4 of the spread), which shifts every x̂ of a group
  by the same k·δ. ``dscale_c = Σ gy·x̂`` moves by k·δ·Σ_hw gy per
  sample (|Σ_hw gy| up to about 3·√64 = 24 here): 1.8e-2 a step and a
  sample; ``dx = r·(gy·s − c1 − x̂·c2)`` moves by r·k·δ·(|c2| + |x̂|·|c1|)
  with r = 50 and |c1|, |c2| up to about 0.1 here: 1.1e-2 a step.
  Measured 3.5e-2 (dscale) and 2.5e-2 (dx, of magnitude up to 343), so
  ``atol=0.1`` (five to nine steps), with ``rtol=1e-4`` as above;
  ``dbias`` has no x̂ and keeps ``GRAD_TOL``.
* the ReLU's tie: at ``y == 0`` both packages pass half the gradient
  (``jnp.maximum``, ``torch.maximum``); a group of zeros with bias 0 puts
  every element of the group there, with r = rsqrt(eps) = 1000, so its
  ``dx`` is of order 1000 and ``GRAD_TOL``'s rtol carries it (one that
  passed the whole gradient would be 500·|dy·s| off).
* the cluster body's arithmetic, emulated in float32 in the kernel's
  order of sums (``_cluster_emulation``): ``F32_TOL`` against the JAX
  reference at unit spread; at mean 200 and spread 0.02, 5e-3 against
  both the JAX reference and a float64 oracle (the JAX package's pin;
  measured 2.3e-3 and 4.0e-4: the second pass's correction of the mean
  leaves it at the float32 step of the mean, 7.6e-4 of the spread, and
  the JAX reference's own sums are farther off).
"""

import ctypes
import os
import re

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
OFFSET_GRAD_TOL = dict(rtol=1e-4, atol=0.1)

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
    """The kernel route's ``autograd.Function``: its forward and backward
    launches are replaced by their plain versions here (the kernels run
    only on a card), so its gradients are the closed form's and must
    match plain autograd of the plain forward."""
    monkeypatch.setattr(tgn, "_group_norm_cuda", tgn.group_norm_reference)
    monkeypatch.setattr(tgn, "_group_norm_bwd_cuda",
                        tgn.group_norm_backward_reference)
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
        torch.testing.assert_close(a, b, **GRAD_TOL)


def _zero_group(x, bias, groups, group=1):
    """Zeros in one group of every sample and 0 bias on its channels: the
    group normalises to exactly 0, the ReLU's tie."""
    cg = x.shape[-1] // groups
    x, bias = x.copy(), bias.copy()
    x[..., group * cg:(group + 1) * cg] = 0.0
    bias[group * cg:(group + 1) * cg] = 0.0
    return x, bias


def _jax_vjp(fn, x, scale, bias, g, groups, relu, dtype):
    """``jax.vjp`` of ``fn`` at ``g``: (dx, dscale, dbias) as float32
    numpy arrays (dx rounded to the input dtype first)."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    _, vjp = jax.vjp(lambda a, s, b: fn(a, s, b, groups, relu=relu),
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g, jdt))]


def _closed_form(x, scale, bias, g, groups, relu, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = tgn.group_norm_backward_reference(
        torch.from_numpy(g).to(tdt), torch.from_numpy(x).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(bias), groups, relu=relu)
    assert got[0].dtype == tdt
    assert got[1].dtype == got[2].dtype == torch.float32
    return [t.float().numpy() for t in got]


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("route", ["autograd", "closed_form"])
def test_relu_tie_passes_half_the_gradient_as_jax(route):
    """A group of zeros with bias 0 sits on the ReLU's tie: the JAX
    package's ``jnp.maximum`` passes half the gradient there, and so must
    the port's plain forward under autograd and its closed form."""
    x, scale, bias, groups = _inputs("unit", seed=8)
    x, bias = _zero_group(x, bias, groups)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    want = _jax_vjp(jax_group_norm, x, scale, bias, g, groups, True, "f32")
    if route == "autograd":
        inputs = [torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias)]
        out = tgn.group_norm(*inputs, groups, relu=True)
        got = [t.numpy() for t in
               torch.autograd.grad(out, inputs, torch.from_numpy(g))]
    else:
        got = _closed_form(x, scale, bias, g, groups, True, "f32")
    cg = x.shape[-1] // groups
    assert np.abs(want[0][..., cg:2 * cg]).max() > 100  # r = 1000 there
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_backward_closed_form_matches_jax_vjp(jax_fn, case, relu, dtype):
    """The closed form against ``jax.vjp`` of the JAX package's function
    (its ``group_norm`` differentiates the reference: ``_gn_bwd``)."""
    x, scale, bias, groups = _inputs(case, seed=10)
    g = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)
    if dtype == "bf16":
        x, g = _bf16_round(x), _bf16_round(g)
    fn = jax_group_norm_reference if jax_fn == "reference" \
        else jax_group_norm
    want = _jax_vjp(fn, x, scale, bias, g, groups, relu, dtype)
    got = _closed_form(x, scale, bias, g, groups, relu, dtype)
    offset = CASES[case][2] > 100 and dtype == "f32"
    tols = [BF16_TOL if dtype == "bf16" else
            OFFSET_GRAD_TOL if offset else GRAD_TOL,
            OFFSET_GRAD_TOL if offset else GRAD_TOL, GRAD_TOL]
    for a, b, tol, name in zip(got, want, tols, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("c,groups", [(32, 32), (64, 32), (64, 8), (128, 2)])
def test_backward_closed_form_over_group_widths(c, groups):
    """cg ∈ {1, 2, 8, 64} on a ragged 13×11 sample, with the ReLU."""
    r = np.random.default_rng(12)
    x = r.normal(size=(2, 13, 11, c)).astype(np.float32)
    scale = r.normal(size=c).astype(np.float32)
    bias = r.normal(size=c).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    want = _jax_vjp(jax_group_norm_reference, x, scale, bias, g, groups,
                    True, "f32")
    got = _closed_form(x, scale, bias, g, groups, True, "f32")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("case", ["unit", "mean_200_spread_0.02"])
def test_autograd_route_lies_within_the_closed_forms_error_bound(case):
    """``backward_error_bound`` (what ``chip_smoke.py`` holds the kernel
    to) at the tolerance the card's check takes for the case, 1e-5 or
    5e-3 of each term, holds the autograd route, which reaches the same
    gradients through another float32 algebra (measured at most 5.2e-8 of
    each term at unit spread, 2.0e-5 at mean 200)."""
    x, scale, bias, groups = _inputs(case, seed=13)
    g = np.random.default_rng(14).normal(size=x.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (g, x, scale, bias)]
    want = tgn.group_norm_backward_reference(*args, groups, relu=True)
    got = tgn.group_norm_backward(*args, groups, relu=True)
    rel = 5e-3 if CASES[case][2] > 100 else 1e-5
    bounds = tgn.backward_error_bound(*args, groups, rel, relu=True)
    for a, b, bound in zip(got, want, bounds):
        assert bool(((a - b).abs() <= bound).all())


def test_tie_elements_marked_exact_get_no_relu_allowance():
    """A group of zeros sits on the ReLU's tie on both sides; marked
    ``exact``, its elements lose the allowance for taking the other side
    of the ReLU, so a backward that passed the whole gradient there
    would fall outside the bound."""
    x, scale, bias, groups = _inputs("unit", seed=15)
    x, bias = _zero_group(x, bias, groups)
    g = np.random.default_rng(16).normal(size=x.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (g, x, scale, bias)]
    want = tgn.group_norm_backward_reference(*args, groups, relu=True)
    # the whole gradient at the tie: dx as if the ReLU's derivative were 1
    cg = x.shape[-1] // groups
    wrong = want[0].clone()
    dy, s = args[0][..., cg:2 * cg], args[2][cg:2 * cg]
    wrong[..., cg:2 * cg] += 0.5 * 1000.0 * dy * s
    exact = torch.zeros(x.shape, dtype=torch.bool)
    exact[..., cg:2 * cg] = True
    loose = tgn.backward_error_bound(*args, groups, 1e-5, relu=True)[0]
    strict = tgn.backward_error_bound(*args, groups, 1e-5, relu=True,
                                      exact=exact)[0]
    assert bool(((wrong - want[0]).abs() <= loose).all())
    assert not bool(((wrong - want[0]).abs() <= strict).all())


def test_backward_wrapper_takes_cuda_tensors_only():
    x = torch.zeros(1, 2, 2, 4)
    before = tgn.backward_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgn._group_norm_bwd_cuda(x, x, torch.ones(4), torch.zeros(4), 2,
                                 1e-6, True)
    assert tgn.backward_launches == before


@pytest.mark.parametrize("n,hw", [(64, 112 * 112), (64, 49), (64, 196),
                                  (1, 7), (3, 143), (2, 1)])
def test_backward_plan_covers_every_row(n, hw):
    p = tgn.backward_plan(n, hw)
    assert p["tile_rows"] * (p["ntiles"] - 1) < hw <= \
        p["tile_rows"] * p["ntiles"]
    assert p["tile_rows"] >= min(hw, tgn._BWD_MIN_ROWS)
    assert n * p["ntiles"] <= max(n, tgn._BWD_RESIDENT)


def test_resnet_step_through_the_kernel_route_matches_the_jax_trainer(
        monkeypatch):
    """One momentum-SGD step of ``resnet18_thin`` through the kernel
    route's ``autograd.Function`` at every GroupNorm site, both launches
    swapped for their plain versions, against the JAX trainer's masked
    step on the same converted weights and batch (its GroupNorm the
    Pallas kernel, whose backward is ``_gn_bwd``). float32 on both sides;
    ``rtol=atol=1e-5`` on the loss and the parameters after the step, as
    ``tests/test_torch_train.py`` holds the trainers."""
    from mmlspark_tpu.models import resnet as jres
    from mmlspark_tpu.train import loop as jloop
    from mmlspark_tpu_torch.models import resnet as tres
    from mmlspark_tpu_torch.models.convert import resnet_state_dict_from_flax
    from mmlspark_tpu_torch.train import loop as tloop

    r = np.random.default_rng(17)
    x = r.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = r.integers(0, 10, 4).astype(np.int64)
    w = np.array([1, 1, 1, 0], np.float32)
    run = dict(batch_size=4, optimizer="momentum", learning_rate=0.1)
    jt = jloop.Trainer(
        jres.resnet18_thin(num_classes=10, dtype=jnp.float32,
                           gn_impl="pallas"),
        jloop.TrainConfig(mesh_spec={"dp": 1}, **run))
    state = jt.init_state(x.shape[1:])

    def to_port(params):
        return resnet_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params))

    init = to_port(state["params"])
    state, metrics = jt.step_masked(state, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(w))
    want = to_port(state["params"])

    calls = {"forward": 0, "backward": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(tgn, "resolve_impl", lambda impl, x: "cuda")
    monkeypatch.setattr(tgn, "_group_norm_cuda",
                        counted("forward", tgn.group_norm_reference))
    monkeypatch.setattr(tgn, "_group_norm_bwd_cuda",
                        counted("backward",
                                tgn.group_norm_backward_reference))
    model = tres.resnet18_thin(num_classes=10, dtype=torch.float32,
                               device="cpu")
    trainer = tloop.Trainer(model, tloop.TrainConfig(device="cpu", **run),
                            initial_state_dict=init)
    loss = trainer.train_step(*(torch.from_numpy(a) for a in (x, y, w)))
    sites = tres.gn_sites(model)
    assert calls == {"forward": sites, "backward": sites}
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-5, atol=1e-5)
    got = trainer.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   rtol=1e-5, atol=1e-5)
    assert max(float((want[k] - init[k]).abs().max()) for k in init) > 1e-3


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
    before = (tgn.launches, tgn.cluster_launches)
    args = (torch.zeros(1, 2, 2, 4), torch.ones(4), torch.zeros(4), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgn.group_norm(*args, impl="cuda")
    tgn.group_norm(*args)  # the plain version on CPU tensors
    assert (tgn.launches, tgn.cluster_launches) == before


@pytest.mark.parametrize("n,hw,c", [(64, 112 * 112, 64), (64, 49, 2048),
                                    (1, 49, 2048), (3, 35, 48)])
def test_kernel_plan_covers_every_row(n, hw, c):
    p = tgn.plan(n, hw, c)
    assert p["tile_rows"] * (p["ntiles"] - 1) < hw <= \
        p["tile_rows"] * p["ntiles"]
    assert p["ct"] * p["rt"] <= 256 and p["apply_blocks"] >= 1


# (H·W, C) of the 12 distinct GroupNorm sites of ResNet-50 at 224², all
# with 32 groups: the stem, then each stage's 1x1 / 3x3 / 1x1 widths
RESNET50_SITES = [(112 * 112, 64), (56 * 56, 64), (56 * 56, 256),
                  (56 * 56, 128), (28 * 28, 128), (28 * 28, 512),
                  (28 * 28, 256), (14 * 14, 256), (14 * 14, 1024),
                  (14 * 14, 512), (7 * 7, 512), (7 * 7, 2048)]


def _check_cluster_plan(p, n, hw, c, dtype, groups):
    elt = torch.empty((), dtype=dtype).element_size()
    k, rows = p["k"], p["rows"]
    # the slabs [q·rows, min((q+1)·rows, hw)) cover every row once, and
    # none is empty
    assert (k - 1) * rows < hw <= k * rows
    assert 1 <= k <= tgn._MAX_CLUSTER and k & (k - 1) == 0
    assert p["threads"] == 256 and p["waves"] >= 1
    vec = p["vec_bytes"] // elt
    assert c % vec == 0 and vec % p["seg"] == 0
    assert (c // groups) % p["seg"] == 0
    # the slab and its tables fit one CTA's 227 KB of shared memory
    smem = tgn.cluster_smem(rows, c, groups, elt, vec, p["threads"],
                            p["seg"])
    assert rows * c * elt < smem == p["smem"] <= 232_448


@pytest.mark.parametrize("n", [64, 1])
@pytest.mark.parametrize("hw,c", RESNET50_SITES)
def test_cluster_plan_takes_every_resnet50_bf16_site(hw, c, n):
    p = tgn.cluster_plan(n, hw, c, torch.bfloat16, 32)
    assert p is not None and p["vec_bytes"] == 16
    _check_cluster_plan(p, n, hw, c, torch.bfloat16, 32)


@pytest.mark.parametrize("n,hw,c,groups,dtype,align", [
    (64, 28 * 28, 512, 32, torch.float32, 16),
    (2, 13 * 11, 64, 32, torch.bfloat16, 16),
    (2, 13 * 11, 96, 32, torch.bfloat16, 16),
    (3, 35, 48, 16, torch.bfloat16, 2),
    (1, 7 * 7, 2048, 32, torch.float32, 4),
    (5, 1, 8, 4, torch.float32, 16)])
def test_cluster_plan_covers_every_row(n, hw, c, groups, dtype, align):
    p = tgn.cluster_plan(n, hw, c, dtype, groups, align)
    assert p is not None
    _check_cluster_plan(p, n, hw, c, dtype, groups)


@pytest.mark.parametrize("hw,c,dtype", [
    (112 * 112, 128, torch.float32), (224 * 224, 64, torch.float32),
    (224 * 224, 128, torch.bfloat16)])
def test_samples_past_the_largest_cluster_take_the_tiled_body(hw, c,
                                                              dtype):
    """A sample past 16 × 227 KB (6.4 MB and more here) has no cluster
    plan, so the wrapper launches the tiled body."""
    elt = torch.empty((), dtype=dtype).element_size()
    assert hw * c * elt > tgn._MAX_CLUSTER * 232_448
    assert tgn.cluster_plan(64, hw, c, dtype, 32) is None
    assert tgn.cluster_plan(1, hw, c, dtype, 32) is None


@pytest.mark.parametrize("hw,c", [(112 * 112, 64), (56 * 56, 256)])
def test_f32_stem_samples_need_clusters_past_the_portable_eight(hw, c):
    """f32 at 112²×64 or 56²×256 is 3.2 MB a sample, more than 8 × 227
    KB: on a card that holds no cluster past the portable 8 it takes the
    tiled body; with the non-portable 16 it fits 200 KB a CTA."""
    portable = tgn.cluster_plan(
        64, hw, c, torch.float32, 32,
        resident=lambda p: 0 if p["k"] > 8 else tgn.resident_estimate(p))
    assert portable is None
    p = tgn.cluster_plan(64, hw, c, torch.float32, 32)
    assert p["k"] == 16
    _check_cluster_plan(p, 64, hw, c, torch.float32, 32)


def test_cluster_size_the_card_cannot_hold_is_not_taken():
    """A cluster size of which the card holds no cluster is skipped; with
    none left the tiled body runs."""
    p = tgn.cluster_plan(64, 112 * 112, 64, torch.bfloat16, 32,
                         resident=lambda p: 0 if p["k"] == 16 else 15)
    assert p["k"] == 8 and p["waves"] == 5
    assert tgn.cluster_plan(64, 112 * 112, 64, torch.bfloat16, 32,
                            resident=lambda p: 0) is None


@pytest.mark.parametrize("hw,c,held,want", [
    # every cluster of a call in one wave beats more, smaller CTAs
    (56 * 56, 64, {2: 66, 4: 62, 8: 45, 16: 28}, 2),
    # one wave either way: the call's CTAs should reach most SMs
    (14 * 14, 256, {1: 264, 2: 264, 4: 124, 8: 62, 16: 28}, 2),
    # three waves either way: two CTAs sharing an SM, then the smaller k
    (56 * 56, 128, {4: 30, 8: 30, 16: 28}, 8),
    (28 * 28, 512, {4: 30, 8: 30, 16: 28}, 8)])
def test_cluster_size_follows_waves_then_coverage(hw, c, held, want):
    """The choice among cluster sizes, given the clusters the card holds
    at once (the occupancy an H100 reported for these bf16 plans)."""
    p = tgn.cluster_plan(64, hw, c, torch.bfloat16, 32,
                         resident=lambda p: held.get(p["k"], 0))
    assert p["k"] == want
    _check_cluster_plan(p, 64, hw, c, torch.bfloat16, 32)


@pytest.mark.parametrize("c,elt,align,want", [
    (64, 2, 16, 16), (96, 2, 16, 16), (12, 2, 16, 8), (6, 2, 16, 4),
    (3, 2, 16, 2), (64, 2, 2, 2), (64, 2, 8, 8), (64, 4, 4, 4),
    (2, 4, 16, 8), (3, 4, 16, 4)])
def test_vector_bytes_follow_the_row_and_the_pointers(c, elt, align, want):
    """A row of C elements or a data pointer that is not a multiple of 16
    bytes narrows every copy, load and store (never below one element)."""
    assert tgn.vector_bytes(c, elt, align) == want


def test_pointer_alignment_of_a_view_with_a_storage_offset():
    base = torch.zeros(256 + 16, dtype=torch.bfloat16)
    first = next(i for i in range(8) if (base.data_ptr() + 2 * i) % 16 == 0)
    for off, want in [(0, 16), (1, 2), (2, 4), (4, 8), (3, 2)]:
        view = base[first + off:first + off + 256].view(2, 4, 4, 8)
        assert tgn._pointer_align(view) == want
        assert tgn._pointer_align(view, torch.empty_like(view)) == want


@pytest.mark.parametrize("cg,vec,want", [(2, 8, 2), (8, 8, 8), (64, 8, 8),
                                         (2, 4, 2), (8, 4, 4), (3, 8, 1),
                                         (12, 8, 1), (5, 1, 1)])
def test_segments_fold_whole_groups_or_whole_vectors(cg, vec, want):
    assert tgn.segment(32 * cg, 32, vec) == want


def _seq_sum(t, dim):
    """Sum over ``dim`` in index order, each addition rounded to float32."""
    t = t.movedim(dim, 0)
    out = torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        out = out + t[i]
    return out


def _cluster_emulation(x, scale, bias, groups, eps, relu, p, elt):
    """The cluster body's arithmetic in plain float32 PyTorch, in its
    order of sums: per CTA (rows [q·R, (q+1)·R) of a sample), each row
    thread sums its rows (stride rt) in row order per chunk of rows,
    folds its channels into segments and adds the chunk into its buffer;
    the row threads in order, then a group's segments in order; the k
    CTAs' partials in rank order; the mean m; then sum(x − m) and
    sum((x − m)²) the same way, the mean corrected by the first and the
    variance taken about it; then (x − mean)·(rstd·scale) + bias."""
    n, h, w, c = x.shape
    hw = h * w
    xs = x.float().reshape(n, hw, c)
    k, rows_per_cta, seg = p["k"], p["rows"], p["seg"]
    cv = c // (p["vec_bytes"] // elt)
    rt = p["threads"] // min(cv, p["threads"])
    cg = c // groups
    count = torch.tensor(float(hw)) * float(cg)

    def thread_sums(rows):  # [r, C] -> [rt, C]
        steps = -(-rows.shape[0] // rt)
        padded = torch.zeros(steps * rt, c)
        padded[:rows.shape[0]] = rows
        return _seq_sum(padded.reshape(steps, rt, c), 0)

    def segments(t):  # [rt, C] -> [rt, C/seg]
        return _seq_sum(t.reshape(rt, c // seg, seg), -1)

    def cta_groups(buf):  # [rt, C/seg] -> [G]
        return _seq_sum(_seq_sum(buf, 0).reshape(groups, cg // seg), -1)

    out = torch.empty_like(xs)
    for i in range(n):
        slabs = [xs[i, q * rows_per_cta:(q + 1) * rows_per_cta]
                 for q in range(k)]
        part1 = []
        for slab in slabs:
            r = slab.shape[0]
            chunks = [segments(thread_sums(slab[r * j // 4:
                                                r * (j + 1) // 4]))
                      for j in range(4)]
            part1.append(cta_groups(_seq_sum(torch.stack(chunks), 0)))
        m = (_seq_sum(torch.stack(part1), 0) / count).repeat_interleave(cg)
        part_d, part_q = [], []
        for slab in slabs:
            d = slab - m
            part_d.append(cta_groups(segments(thread_sums(d))))
            part_q.append(cta_groups(segments(thread_sums(d * d))))
        dm = _seq_sum(torch.stack(part_d), 0) / count
        var = torch.clamp_min(_seq_sum(torch.stack(part_q), 0) / count
                              - dm * dm, 0.0)
        mean = m + dm.repeat_interleave(cg)
        rstd = (1.0 / torch.sqrt(var + eps)).repeat_interleave(cg)
        y = (xs[i] - mean) * (rstd * scale) + bias
        out[i] = torch.clamp_min(y, 0.0) if relu else y
    return out.reshape(n, h, w, c)


@pytest.mark.parametrize("center", [0.0, 200.0])
@pytest.mark.parametrize("dtype,align", [("f32", 16), ("bf16", 16),
                                         ("bf16", 2)])
@pytest.mark.parametrize("c,groups", [(64, 32), (64, 8), (128, 2)])
def test_cluster_order_of_sums_against_jax_oracle(c, groups, dtype, align,
                                                  center):
    """The cluster body's order of sums on a ragged 13×11 sample cut in
    k = 8 slabs (the last of 17 rows), at cg ∈ {2, 8, 64} and the
    vectors of 16-byte f32 and bf16 words and of single bf16 elements.
    The values are float32: the order is what is under test."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    elt = 4 if dtype == "f32" else 2
    p = tgn.cluster_plan(2, 143, c, tdt, groups, align,
                         resident=lambda p: int(p["k"] == 8))
    assert p["k"] == 8 and 143 - 7 * p["rows"] == 17
    r = np.random.default_rng(11)
    spread = 0.02 if center else 1.0
    x = r.normal(center, spread, (2, 13, 11, c)).astype(np.float32)
    if center:
        scale, bias = np.ones(c, np.float32), np.zeros(c, np.float32)
    else:
        scale = r.normal(size=c).astype(np.float32)
        bias = r.normal(size=c).astype(np.float32)
    relu = not center
    got = _cluster_emulation(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), groups, 1e-6, relu, p,
                             elt).numpy()
    want = np.asarray(jax_group_norm_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
        relu=relu))
    if not center:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    assert np.abs(got - want).max() < 5e-3
    xf = x.astype(np.float64).reshape(2, 143, groups, c // groups)
    mean = xf.mean(axis=(1, 3), keepdims=True)
    var = ((xf - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    oracle = ((xf - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    assert np.abs(got - oracle).max() < 5e-3


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at ResNet-50
    shapes and the edge cases, through the body its shape takes (the
    cluster body, or the tiled body for a sample past the largest
    cluster), each launch twice on the same input: equal bit for bit.
    Tolerance: float32 outputs 1e-4 (f32 statistics summed in another
    order); bfloat16 one step of the output (both round one float32
    result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # shape, groups, dtype, center, spread, storage offset, body
    for shape, groups, dtype, center, spread, offset, body in [
            ((8, 112, 112, 64), 32, torch.bfloat16, 0.0, 1.0, 0, "cluster"),
            ((8, 7, 7, 2048), 32, torch.float32, 0.0, 1.0, 0, "cluster"),
            ((2, 8, 8, 32), 8, torch.float32, 200.0, 0.02, 0, "cluster"),
            ((1, 13, 11, 64), 32, torch.bfloat16, 0.0, 1.0, 0, "cluster"),
            ((4, 13, 11, 96), 32, torch.bfloat16, 0.0, 1.0, 0, "cluster"),
            ((8, 28, 28, 512), 32, torch.bfloat16, 0.0, 1.0, 0, "cluster"),
            ((2, 14, 14, 256), 32, torch.bfloat16, 0.0, 1.0, 1, "cluster"),
            ((2, 13, 11, 64), 32, torch.float32, 0.0, 1.0, 1, "cluster"),
            ((2, 112, 112, 64), 32, torch.float32, 0.0, 1.0, 0, "cluster"),
            ((2, 112, 112, 128), 32, torch.float32, 0.0, 1.0, 0, "tiled")]:
        numel = int(np.prod(shape))
        flat = (center + spread * torch.randn(numel + offset, generator=gen,
                                              device=dev)).to(dtype)
        # a contiguous view with a storage offset: a base pointer that is
        # not 16-byte aligned
        x = flat[offset:].view(shape)
        scale = torch.randn(shape[-1], generator=gen, device=dev)
        bias = torch.randn(shape[-1], generator=gen, device=dev)
        before = (tgn.launches, tgn.cluster_launches)
        got = tgn.group_norm(x, scale, bias, groups, relu=True)
        again = tgn.group_norm(x, scale, bias, groups, relu=True)
        torch.cuda.synchronize()
        clustered = 2 if body == "cluster" else 0
        assert (tgn.launches, tgn.cluster_launches) == \
            (before[0] + 2, before[1] + clustered), (shape, dtype, body)
        assert torch.equal(got, again), (shape, dtype)
        want = tgn.group_norm(x, scale, bias, groups, relu=True,
                              impl="torch")
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol if spread >= 1 else 5e-3)


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_closed_form():
    """The backward kernel against its plain version (the closed form) on
    the card, at ResNet-50 shapes and the edge cases, each launched twice
    on the same input (equal bit for bit), with ``dy`` contiguous and as
    a strided view (copied once by the wrapper). Tolerance:
    ``backward_error_bound`` at 1e-5 of each term (5e-3 at mean 200: a few
    float32 steps of the mean over its spread), the tie's zero group marked
    exact, plus one bfloat16 step (2^-7 of the value) where dx is
    bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # shape, groups, dtype, center, spread, storage offset, zero group
    for shape, groups, dtype, center, spread, offset, zero in [
            ((8, 56, 56, 64), 32, torch.bfloat16, 0.0, 1.0, 0, False),
            ((8, 7, 7, 2048), 32, torch.float32, 0.0, 1.0, 0, False),
            ((2, 8, 8, 32), 8, torch.float32, 200.0, 0.02, 0, False),
            ((4, 13, 11, 96), 32, torch.bfloat16, 0.0, 1.0, 0, False),
            ((2, 14, 14, 256), 32, torch.bfloat16, 0.0, 1.0, 1, False),
            ((2, 13, 11, 64), 32, torch.float32, 0.0, 1.0, 1, False),
            ((4, 28, 28, 128), 32, torch.bfloat16, 0.0, 1.0, 0, True),
            ((2, 112, 112, 128), 32, torch.float32, 0.0, 1.0, 0, False)]:
        numel = int(np.prod(shape))
        flat = (center + spread * torch.randn(numel + offset, generator=gen,
                                              device=dev)).to(dtype)
        x = flat[offset:].view(shape)
        scale = torch.randn(shape[-1], generator=gen, device=dev)
        bias = torch.randn(shape[-1], generator=gen, device=dev)
        exact = None
        if zero:
            cg = shape[-1] // groups
            x[..., cg:2 * cg] = 0
            bias[cg:2 * cg] = 0
            exact = torch.zeros(shape, dtype=torch.bool, device=dev)
            exact[..., cg:2 * cg] = True
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        # dy as autograd may hand it over: an NCHW-contiguous tensor seen
        # as NHWC
        strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        before = (tgn.backward_launches, tgn.backward_dy_copies)
        got = tgn._group_norm_bwd_cuda(dy, x, scale, bias, groups, 1e-6,
                                       True)
        again = tgn._group_norm_bwd_cuda(strided, x, scale, bias, groups,
                                         1e-6, True)
        torch.cuda.synchronize()
        assert (tgn.backward_launches, tgn.backward_dy_copies) == \
            (before[0] + 2, before[1] + 1), (shape, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            (shape, dtype)
        want = tgn.group_norm_backward_reference(dy, x, scale, bias, groups,
                                                 relu=True)
        rel = 5e-3 if spread < 1 else 1e-5
        bounds = tgn.backward_error_bound(dy, x, scale, bias, groups, rel,
                                          relu=True, exact=exact)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        for i, (a, b, bound) in enumerate(zip(got, want, bounds)):
            if i == 0 and dtype == torch.bfloat16:
                bound = bound + 2 ** -7 * b.float().abs()
            assert bool(((a.float() - b.float()).abs() <= bound).all()), \
                (shape, dtype, i)


def _warp_sum(v):
    """A warp's sum of ``v`` (one value a channel): lane l adds channels
    l, l + 32, … in order, then a shuffle tree (offsets 16, 8, 4, 2, 1)
    into lane 0, each addition rounded to float32."""
    lanes = [torch.zeros((), dtype=torch.float32) for _ in range(32)]
    for j in range(v.shape[0]):
        lanes[j % 32] = lanes[j % 32] + v[j]
    off = 16
    while off:
        lanes = [lanes[i] + lanes[i + off] if i + off < 32 else lanes[i]
                 for i in range(32)]
        off //= 2
    return lanes[0]


def _bwd_statistics_emulation(x, groups, eps):
    """The backward's statistics in float32, in the kernels' order: per
    tile of :func:`backward_plan` and channel, sums of x − K_c over the
    tile's rows with K_c the tile's first value of the channel; per group,
    the channels by a warp (``gn_bwd_stats``); then the tiles merged with
    Chan's formula as ``gn_merge`` merges them (lane t holds tile t, then
    a shuffle tree). Returns (mean, rstd) ``[N, G]``."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    p = tgn.backward_plan(n, hw)
    xs = x.float().reshape(n, hw, c)
    f = torch.float32

    def chan(a, b):  # (count, mean, M2) of a absorbing b, in float32
        (na, ma, qa), (nb, mb, qb) = a, b
        if nb == 0:
            return a
        if na == 0:
            return b
        nab = na + nb
        d = mb - ma
        return (nab, ma + d * (nb / nab), qa + qb + d * d * (na * nb / nab))

    mean = torch.empty(n, groups)
    rstd = torch.empty(n, groups)
    for i in range(n):
        lanes = [[] for _ in range(groups)]
        for t in range(p["ntiles"]):
            tile = xs[i, t * p["tile_rows"]:(t + 1) * p["tile_rows"]]
            rows = torch.tensor(float(tile.shape[0]), dtype=f)
            k = tile[0]
            s1 = _seq_sum(tile - k, 0)
            s2 = _seq_sum((tile - k) ** 2, 0)
            for g in range(groups):
                sl = slice(g * cg, (g + 1) * cg)
                d = (k[sl] - k[g * cg]) + s1[sl] / rows
                dbar = _warp_sum(d) / torch.tensor(float(cg), dtype=f)
                e = d - dbar
                m2 = _warp_sum((s2[sl] - s1[sl] * (s1[sl] / rows))
                               + rows * e * e)
                lanes[g].append((rows * cg, k[g * cg] + dbar, m2))
        for g in range(groups):
            lane = [(0, 0.0, 0.0)] * 32
            for t, moments in enumerate(lanes[g]):
                lane[t % 32] = chan(lane[t % 32], moments)
            off = 16
            while off:
                lane = [chan(lane[j], lane[j + off]) if j + off < 32
                        else lane[j] for j in range(32)]
                off //= 2
            cnt, m, q = lane[0]
            mean[i, g] = m
            rstd[i, g] = 1.0 / torch.sqrt(
                torch.clamp_min(q / cnt, 0.0) + torch.tensor(eps, dtype=f))
    return mean, rstd


@pytest.mark.parametrize("center", [0.0, 200.0])
@pytest.mark.parametrize("shape,groups", [((2, 13, 11, 64), 8),
                                          ((1, 40, 40, 32), 32)])
def test_backward_statistics_scheme_against_a_float64_oracle(shape, groups,
                                                             center):
    """The backward kernel's statistics (shifted sums per tile, Chan's
    merge of the tiles) in float32 against a float64 oracle: at unit
    spread within 1e-6 (mean) and 1e-5 (rstd, relative); at mean 200 and
    spread 0.02 the mean within two float32 steps of 200 (each 1.53e-5,
    7.6e-4 of the spread: the nearest float32 to the true mean is up to
    half a step off, and the last add to K_0 and each Chan merge round
    once; measured 1.6e-5), and rstd within 1e-3 relative (measured
    4.0e-5): the shifted sums leave no cancellation against the mean."""
    spread = 0.02 if center else 1.0
    x = np.random.default_rng(18).normal(center, spread,
                                         shape).astype(np.float32)
    assert tgn.backward_plan(shape[0], shape[1] * shape[2])["ntiles"] > 1
    mean, rstd = _bwd_statistics_emulation(torch.from_numpy(x), groups,
                                           1e-6)
    xf = x.astype(np.float64).reshape(shape[0], -1, groups,
                                      shape[-1] // groups)
    want_mean = xf.mean(axis=(1, 3))
    want_rstd = 1 / np.sqrt(xf.var(axis=(1, 3)) + 1e-6)
    mean_tol = 2 * 2.0 ** -16 if center else 1e-6
    rstd_tol = 1e-3 if center else 1e-5
    assert np.abs(mean.numpy() - want_mean).max() < mean_tol
    assert (np.abs(rstd.numpy() - want_rstd) / want_rstd).max() < rstd_tol


# ---------------------------------------------------------------------------
# The backward's cluster body (gn_bwd_cluster): its plan, and its order of
# sums emulated in float32 against the JAX package's vjp
# ---------------------------------------------------------------------------


def _check_backward_cluster_plan(p, n, hw, c, dtype, groups):
    elt = torch.empty((), dtype=dtype).element_size()
    k, rows = p["k"], p["rows"]
    # the slabs [q·rows, min((q+1)·rows, hw)) cover every row once, and
    # none is empty
    assert (k - 1) * rows < hw <= k * rows
    assert 1 <= k <= tgn._MAX_CLUSTER and k & (k - 1) == 0
    assert p["threads"] == 256 and p["waves"] >= 1
    vec = p["vec_bytes"] // elt
    assert c % vec == 0 and vec % p["seg"] == 0
    assert (c // groups) % p["seg"] == 0
    # x's and dy's slabs and the tables fit one CTA's 227 KB
    smem = tgn.backward_cluster_smem(rows, c, groups, elt, vec,
                                     p["threads"], p["seg"])
    assert 2 * rows * c * elt < smem == p["smem"] <= 232_448


@pytest.mark.parametrize("n", [64, 1])
@pytest.mark.parametrize("hw,c", RESNET50_SITES)
def test_backward_cluster_plan_takes_every_resnet50_bf16_site(hw, c, n):
    p = tgn.backward_cluster_plan(n, hw, c, torch.bfloat16, 32)
    assert p is not None and p["vec_bytes"] == 16
    _check_backward_cluster_plan(p, n, hw, c, torch.bfloat16, 32)


@pytest.mark.parametrize("n,hw,c,groups,dtype,align", [
    (64, 28 * 28, 512, 32, torch.float32, 16),
    (64, 56 * 56, 128, 32, torch.float32, 16),
    (2, 13 * 11, 64, 32, torch.bfloat16, 16),
    (2, 13 * 11, 96, 32, torch.bfloat16, 16),
    (3, 35, 48, 16, torch.bfloat16, 2),
    (1, 7 * 7, 512, 32, torch.float32, 4),
    (5, 1, 8, 4, torch.float32, 16)])
def test_backward_cluster_plan_covers_every_row(n, hw, c, groups, dtype,
                                                align):
    p = tgn.backward_cluster_plan(n, hw, c, dtype, groups, align)
    assert p is not None
    _check_backward_cluster_plan(p, n, hw, c, dtype, groups)


@pytest.mark.parametrize("hw,c", [(112 * 112, 64), (56 * 56, 256),
                                  (112 * 112, 128)])
def test_backward_f32_samples_past_the_largest_cluster_take_five_launches(
        hw, c):
    """An f32 sample whose x and dy pass 16 × 227 KB (6.4 MB and more
    here) has no backward cluster plan: the five-launch body runs."""
    assert 2 * hw * c * 4 > tgn._MAX_CLUSTER * 232_448
    for n in (64, 1):
        assert tgn.backward_cluster_plan(n, hw, c, torch.float32, 32) is None


def test_backward_cluster_size_the_card_cannot_hold_is_not_taken():
    """bf16 at 112²×64 needs 16 CTAs a sample for x and dy: a card that
    holds no such cluster leaves the five-launch body; at 56²×64 a refused
    k = 8 gives way to another size."""
    held = tgn.backward_cluster_plan(64, 112 * 112, 64, torch.bfloat16, 32)
    assert held["k"] == 16
    assert tgn.backward_cluster_plan(
        64, 112 * 112, 64, torch.bfloat16, 32,
        resident=lambda p: 0 if p["k"] == 16 else 99) is None
    p = tgn.backward_cluster_plan(
        64, 56 * 56, 64, torch.bfloat16, 32,
        resident=lambda p: 0 if p["k"] == 8 else 30)
    assert p["k"] not in (8,) and p["waves"] == 3
    _check_backward_cluster_plan(p, 64, 56 * 56, 64, torch.bfloat16, 32)


def _fma(a, b, c):
    """fmaf in float32: the exact product, one rounding of the sum (the
    float64 sum of a float32 product and addend, rounded to float32)."""
    return (a.double() * b.double() + c.double()).float()


def _cluster_bwd_emulation(dy, x, scale, bias, groups, eps, relu, p, elt):
    """The backward's cluster body in plain float32 PyTorch, in its order
    of sums: the statistics as the forward's cluster body takes them (per
    chunk, row thread, segment, group, then the k CTAs in rank order;
    the mean, then sum(x − m) and sum((x − m)²)); per CTA and channel the
    sums of gy and gy·x̂ (x̂ = (x − mean)·rstd, y = fma(x̂, s, b), gy = dy
    times the ReLU's derivative, 0.5 at y == 0) each thread over its rows
    in row order, then the row threads in order; per group the channels'
    fma(s, ·) in order, the CTAs in rank order, over H·W·cg: c1, c2; each
    channel's sums over the CTAs in rank order, then over the samples in
    order: dbias, dscale; dx = rstd·fma(−x̂, c2, fma(gy, s, −c1))."""
    n, h, w, c = x.shape
    hw = h * w
    xs = x.float().reshape(n, hw, c)
    gs = dy.float().reshape(n, hw, c)
    k, rows_per_cta, seg = p["k"], p["rows"], p["seg"]
    cv = c // (p["vec_bytes"] // elt)
    rt = p["threads"] // min(cv, p["threads"])
    cg = c // groups
    count = torch.tensor(float(hw)) * float(cg)

    def thread_sums(rows):  # [r, C] -> [rt, C]
        steps = -(-rows.shape[0] // rt)
        padded = torch.zeros(steps * rt, c)
        padded[:rows.shape[0]] = rows
        return _seq_sum(padded.reshape(steps, rt, c), 0)

    def segments(t):  # [rt, C] -> [rt, C/seg]
        return _seq_sum(t.reshape(rt, c // seg, seg), -1)

    def cta_groups(buf):  # [rt, C/seg] -> [G]
        return _seq_sum(_seq_sum(buf, 0).reshape(groups, cg // seg), -1)

    def rank_sum(parts):
        return _seq_sum(torch.stack(parts), 0)

    dx = torch.empty_like(xs)
    part = torch.empty(n, c, 2)
    for i in range(n):
        cut = [slice(q * rows_per_cta, (q + 1) * rows_per_cta)
               for q in range(k)]
        slabs = [xs[i, s] for s in cut]
        part1 = []
        for slab in slabs:
            r = slab.shape[0]
            chunks = [segments(thread_sums(slab[r * j // 4:
                                                r * (j + 1) // 4]))
                      for j in range(4)]
            part1.append(cta_groups(_seq_sum(torch.stack(chunks), 0)))
        m = (rank_sum(part1) / count).repeat_interleave(cg)
        part_d, part_q = [], []
        for slab in slabs:
            d = slab - m
            part_d.append(cta_groups(segments(thread_sums(d))))
            part_q.append(cta_groups(segments(thread_sums(d * d))))
        dm = rank_sum(part_d) / count
        var = torch.clamp_min(rank_sum(part_q) / count - dm * dm, 0.0)
        mean = m + dm.repeat_interleave(cg)
        rstd = (1.0 / torch.sqrt(var + eps)).repeat_interleave(cg)

        def terms(s):
            xh = (xs[i, s] - mean) * rstd
            y = _fma(xh, scale, bias)
            g = gs[i, s]
            if relu:
                g = g * torch.where(y > 0, 1.0, torch.where(y == 0, 0.5,
                                                            0.0))
            return xh, g

        part3, cparts = [], []
        for s in cut:
            xh, g = terms(s)
            r = xh.shape[0]
            steps = -(-r // rt)
            a = torch.zeros(rt, c)
            bq = torch.zeros(rt, c)
            for j in range(steps):  # thread ty takes rows j·rt + ty
                lo, hi = j * rt, min((j + 1) * rt, r)
                a[:hi - lo] = a[:hi - lo] + g[lo:hi]
                bq[:hi - lo] = _fma(g[lo:hi], xh[lo:hi], bq[:hi - lo])
            cpart = torch.stack([_seq_sum(a, 0), _seq_sum(bq, 0)], -1)
            cparts.append(cpart)
            s12 = torch.zeros(groups, 2)
            for j in range(cg):
                s12 = _fma(scale[j::cg, None], cpart[j::cg], s12)
            part3.append(s12)
        coef = (rank_sum(part3) / count).repeat_interleave(cg, 0)
        total = rank_sum(cparts)
        part[i] = total.flip(-1)  # (sum gy·x̂, sum gy)
        for s in cut:
            xh, g = terms(s)
            inner = _fma(g, scale, -coef[:, 0])
            dx[i, s] = rstd * _fma(-xh, coef[:, 1], inner)
    folded = _seq_sum(part, 0)
    return dx.reshape(x.shape), folded[:, 0], folded[:, 1]


def _closed_form_float64(dy, x, scale, bias, groups, eps, relu):
    """The closed form in float64 (the ReLU's mask from the float64 y)."""
    n, h, w, c = x.shape
    cg = c // groups
    xf = x.astype(np.float64).reshape(n, h * w, groups, cg)
    mean = xf.mean(axis=(1, 3), keepdims=True)
    r = 1 / np.sqrt(((xf - mean) ** 2).mean(axis=(1, 3), keepdims=True)
                    + eps)
    xh = (xf - mean) * r
    s = scale.astype(np.float64).reshape(groups, cg)
    y = xh * s + bias.astype(np.float64).reshape(groups, cg)
    gy = dy.astype(np.float64).reshape(xf.shape)
    if relu:
        gy = gy * np.where(y > 0, 1.0, np.where(y == 0, 0.5, 0.0))
    c1 = (s * gy).mean(axis=(1, 3), keepdims=True)
    c2 = (s * gy * xh).mean(axis=(1, 3), keepdims=True)
    dx = r * (gy * s - c1 - xh * c2)
    return (dx.reshape(x.shape), (gy * xh).sum(axis=(0, 1)).reshape(c),
            gy.sum(axis=(0, 1)).reshape(c))


def _cluster_bwd_case(c, groups, mode, center, dtype):
    """A ragged 13×11 sample in k = 8 slabs (the last of 17 rows), numpy
    seeded; mode "plain", "relu", or "relu_zero" (a group of zeros with
    bias 0 on the ReLU's tie). Returns the emulation's gradients, the
    inputs and the tie mask."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    elt = 4 if dtype == "f32" else 2
    p = tgn.backward_cluster_plan(2, 143, c, tdt, groups,
                                  resident=lambda p: int(p["k"] == 8))
    assert p["k"] == 8 and 143 - 7 * p["rows"] == 17
    r = np.random.default_rng(19)
    spread = 0.02 if center else 1.0
    x = r.normal(center, spread, (2, 13, 11, c)).astype(np.float32)
    scale = r.normal(size=c).astype(np.float32)
    bias = r.normal(size=c).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    exact = None
    if mode == "relu_zero":
        x, bias = _zero_group(x, bias, groups)
        exact = torch.zeros(x.shape, dtype=torch.bool)
        exact[..., c // groups:2 * (c // groups)] = True
    relu = mode != "plain"
    got = _cluster_bwd_emulation(
        *(torch.from_numpy(a) for a in (g, x, scale, bias)), groups, 1e-6,
        relu, p, elt)
    return got, (g, x, scale, bias), relu, exact


@pytest.mark.parametrize("center", [0.0, 200.0])
@pytest.mark.parametrize("mode", ["plain", "relu", "relu_zero"])
@pytest.mark.parametrize("c,groups", [(64, 32), (64, 8), (128, 2)])
def test_backward_cluster_order_of_sums_against_jax_vjp(c, groups, mode,
                                                        center):
    """The backward's cluster body, its arithmetic emulated in float32 in
    its order of sums (bf16 words of 8 channels a thread, float32
    values), against ``jax.vjp`` of the JAX package's
    ``group_norm_reference``, at cg ∈ {2, 8, 64}, within
    ``backward_error_bound`` at the card's check's tolerance: 1e-5 of each
    term at unit spread, 5e-3 at mean 200 and spread 0.02 (a few float32
    steps of the mean over its spread shift x̂ of a whole group, on both
    sides), the tie's zero group granted nothing. At mean 200 the
    emulation is also held against the closed form in float64."""
    got, args, relu, exact = _cluster_bwd_case(c, groups, mode, center,
                                               "bf16")
    g, x, scale, bias = args
    want = _jax_vjp(jax_group_norm_reference, x, scale, bias, g, groups,
                    relu, "f32")
    rel = 5e-3 if center else 1e-5
    bounds = tgn.backward_error_bound(
        *(torch.from_numpy(a) for a in args), groups, rel, relu=relu,
        exact=exact)
    wants = [want]
    if center:
        wants.append(_closed_form_float64(g, x, scale, bias, groups, 1e-6,
                                          relu))
    for ref in wants:
        for a, b, bound, name in zip(got, ref, bounds,
                                     ("dx", "dscale", "dbias")):
            err = np.abs(a.numpy() - np.asarray(b, np.float32))
            assert (err <= bound.numpy()).all(), (name, err.max())
    if mode == "relu_zero":  # r = 1000 on the tie: half the gradient
        cg = c // groups
        assert np.abs(want[0][..., cg:2 * cg]).max() > 100


@pytest.mark.parametrize("center", [0.0, 200.0])
def test_backward_cluster_order_of_sums_in_f32_words(center):
    """The same with f32 words (4 channels a thread), the ReLU on, cg 8."""
    got, args, relu, exact = _cluster_bwd_case(64, 8, "relu", center, "f32")
    g, x, scale, bias = args
    want = _jax_vjp(jax_group_norm_reference, x, scale, bias, g, 8, relu,
                    "f32")
    bounds = tgn.backward_error_bound(
        *(torch.from_numpy(a) for a in args), 8, 5e-3 if center else 1e-5,
        relu=relu)
    for a, b, bound in zip(got, want, bounds):
        assert (np.abs(a.numpy() - b) <= bound.numpy()).all()


@pytest.mark.parametrize("name", sorted(tgn._ARGTYPES))
def test_c_signature_matches_ctypes_types(name):
    """Each ``extern "C"`` entry of ``group_norm.cu`` against the ctypes
    types the wrapper sets: the same count and kind of every argument (a
    mismatch would show only on the card)."""
    src = os.path.join(os.path.dirname(tgn.__file__), "csrc",
                       "group_norm.cu")
    with open(src) as f:
        text = f.read()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert sig is not None, name
    kinds = []
    for param in (p.strip() for p in sig.group(1).split(",")):
        if param.startswith("int* "):
            kinds.append(ctypes.POINTER(ctypes.c_int))
        elif "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(param)
    assert kinds == tgn._ARGTYPES[name]


@pytest.mark.cuda
def test_cuda_backward_cluster_body_matches_closed_form():
    """The backward's cluster body on the card against its plain version
    (the closed form) at bf16 ResNet-50 shapes, a ragged sample and the
    zero group, each launched twice (equal bit for bit) and counted in
    ``backward_cluster_launches``. Tolerance as
    ``test_cuda_backward_kernel_matches_closed_form``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for shape, dtype, zero in [
            ((8, 112, 112, 64), torch.bfloat16, False),
            ((8, 28, 28, 512), torch.bfloat16, False),
            ((8, 7, 7, 2048), torch.bfloat16, True),
            ((3, 13, 11, 64), torch.float32, True)]:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        scale = torch.randn(shape[-1], generator=gen, device=dev)
        bias = torch.randn(shape[-1], generator=gen, device=dev)
        exact = None
        if zero:
            cg = shape[-1] // 32
            x[..., cg:2 * cg] = 0
            bias[cg:2 * cg] = 0
            exact = torch.zeros(shape, dtype=torch.bool, device=dev)
            exact[..., cg:2 * cg] = True
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        before = (tgn.backward_launches, tgn.backward_cluster_launches)
        got = tgn._group_norm_bwd_cuda(dy, x, scale, bias, 32, 1e-6, True)
        again = tgn._group_norm_bwd_cuda(dy, x, scale, bias, 32, 1e-6, True)
        torch.cuda.synchronize()
        assert (tgn.backward_launches, tgn.backward_cluster_launches) == \
            (before[0] + 2, before[1] + 2), shape
        assert all(torch.equal(a, b) for a, b in zip(got, again)), shape
        want = tgn.group_norm_backward_reference(dy, x, scale, bias, 32,
                                                 relu=True)
        bounds = tgn.backward_error_bound(dy, x, scale, bias, 32, 1e-5,
                                          relu=True, exact=exact)
        for i, (a, b, bound) in enumerate(zip(got, want, bounds)):
            if i == 0 and dtype == torch.bfloat16:
                bound = bound + 2 ** -7 * b.float().abs()
            assert bool(((a.float() - b.float()).abs() <= bound).all()), \
                (shape, i)
