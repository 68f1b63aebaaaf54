"""The port's ResNet (mmlspark_tpu_torch/models/resnet.py) against the JAX
ResNet (``norm="group"``).

flax ``resnet18_thin`` params from ``init_bundle`` are converted by
``models/convert.py``; the same numpy-seeded inputs go through the JAX
module (GroupNorm as ``gn_impl="xla"``, flax's ``nn.GroupNorm``, and as
``"pallas"``, the kernel in interpret mode on the CPU) and the port (on
CPU tensors, its plain GroupNorm). An even input (32) and an odd one (35)
pin flax's ``SAME`` padding: asymmetric for the stride-2 stem, convs and
max-pool on even sizes, symmetric on odd ones.

Tolerances:

* float32: ``rtol=atol=1e-5``. Both sides compute in float32 and differ
  in summation order (and flax's ``nn.GroupNorm`` takes the one-pass
  variance where the port takes the centred one): measured at most
  1.5e-6 on features of magnitude 4.7.
* bfloat16: ``rtol=atol=2e-2``. Both sides cast params and activations
  to bfloat16 at the same places, but each rounds a conv or a GroupNorm
  output to bfloat16 (a step of 0.4–0.8% of the value) after accumulating
  in its own order, and 20 layers carry a flipped rounding on. Measured
  at most 1.6e-2 on features of magnitude 4.7 (one bfloat16 step in
  [4, 8) is 3.1e-2).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mmlspark_tpu.models import resnet as jres  # noqa: E402
from mmlspark_tpu.models.zoo import init_bundle  # noqa: E402
from mmlspark_tpu_torch.models import resnet as tres  # noqa: E402
from mmlspark_tpu_torch.models.convert import (  # noqa: E402
    resnet_state_dict_from_flax,
)
from mmlspark_tpu_torch.models.zoo import get_model  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """flax params as numpy arrays; cached, so callers must not mutate."""
    bundle = init_bundle(jres.resnet18_thin(num_classes=10), (32, 32, 3),
                         "ResNet_Small", preprocess="imagenet_norm",
                         seed=seed)
    return jax.tree_util.tree_map(np.asarray, bundle.params)


def _port(dtype, gn_impl="auto"):
    model = tres.resnet18_thin(num_classes=10, dtype=dtype, gn_impl=gn_impl,
                               device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(_params()))
    return model


def _images(side, n=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("side", [32, 35])
@pytest.mark.parametrize("gn_impl", ["xla", "pallas"])
def test_matches_the_jax_resnet(gn_impl, side, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _images(side)
    jm = jres.resnet18_thin(num_classes=10, dtype=jdt, gn_impl=gn_impl)
    both = jax.jit(lambda p, a: {node: jm.apply({"params": p}, a,
                                                output=node)
                                 for node in ("features", "logits")})
    wants = both(_params(), jnp.asarray(x))
    model = _port(tdt)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for node in ("features", "logits"):
        want = np.asarray(wants[node])
        with torch.no_grad():
            got = model(torch.from_numpy(x), output=node)
        assert got.dtype == torch.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (35, 7, 2, (3, 3)),
    (17, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
    (7, 3, 1, (1, 1)), (1, 3, 2, (1, 1))])
def test_same_pads_follow_flax(size, k, s, want):
    assert tres.same_pads(size, k, s) == want
    out = -(-size // s)
    lo, hi = want
    assert (size + lo + hi - k) // s + 1 == out


def test_resnet50_has_the_jax_packages_parameters():
    """Full width: every flax ResNet-50 parameter converts onto a port
    parameter of the same role and shape, and nothing is left over."""
    shapes = jax.eval_shape(
        lambda: jres.resnet50().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 224, 224, 3))))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    converted = resnet_state_dict_from_flax(params)
    model = tres.resnet50(device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
    assert tres.gn_sites(model) == 53
    assert sum(v.numel() for v in converted.values()) == 25_557_032


def test_zoo_entries_are_seeded():
    a = get_model("ResNet_Small", seed=0, device="cpu")
    b = get_model("ResNet_Small", seed=0, device="cpu")
    c = get_model("ResNet_Small", seed=1, device="cpu")
    assert a.input_spec == (32, 32, 3) and a.preprocess == "imagenet_norm"
    assert a.output_names == ("features", "logits")
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_stem.weight"], sc["conv_stem.weight"])
    # flax's initialisers: unit GroupNorm scales, zero biases, truncated
    # LeCun-normal kernels inside two standard deviations
    assert torch.equal(sa["gn_stem.scale"], torch.ones(16))
    assert torch.equal(sa["head.bias"], torch.zeros(10))
    w = sa["blocks.stage1_block0.conv2.weight"]
    std = (1.0 / w[0].numel()) ** 0.5
    assert w.abs().max() <= 2 * std / tres._TRUNC_STD
    assert abs(float(w.std()) - std) < 0.1 * std
    x = torch.from_numpy(_images(32, n=2))
    with torch.no_grad():
        out = a.module(x)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_gn_impl_takes_the_ports_vocabulary():
    for impl in ("pallas", "xla"):
        with pytest.raises(ValueError, match="gn_impl"):
            tres.resnet18_thin(gn_impl=impl, device="cpu")
    model = tres.resnet18_thin(gn_impl="cuda", device="cpu")
    assert {m.impl for m in model.modules()
            if isinstance(m, tres.GroupNorm)} == {"cuda"}
    with pytest.raises(ValueError, match="CUDA tensors"):
        model(torch.zeros(1, 32, 32, 3))


def test_activations_stay_nhwc_contiguous_for_the_kernel():
    """Every GroupNorm site receives a contiguous NHWC tensor: the conv's
    channels-last output seen through a permute, no copy."""
    model = _port(torch.float32)
    seen = []
    for m in model.modules():
        if isinstance(m, tres.GroupNorm):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(args[0].is_contiguous()))
    with torch.no_grad():
        model(torch.from_numpy(_images(32, n=2)))
    assert len(seen) == tres.gn_sites(model) and all(seen)


def test_unknown_output_node_raises():
    with pytest.raises(ValueError, match="output node"):
        _port(torch.float32)(torch.zeros(1, 32, 32, 3), output="pool")
