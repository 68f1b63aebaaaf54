"""The port's CIFAR-10 ConvNet (mmlspark_tpu_torch/models/convnet.py) and
its train, score and serve paths against the JAX package.

Parameters are made with numpy from a seed in flax's tree (kernels of
stddev ``1/sqrt(fan_in)``, biases of stddev 0.1, so that the bias order
shows) and converted by ``models/convert.py``; the JAX modules take them
through :class:`_NumpyInit`, whose ``init`` returns them (flax's own init
compiles its random draws for seconds on the CPU). The same numpy-seeded
inputs go through the JAX module and the port on the CPU, at widths
(8, 16) with dense width 32 (the trainer at (4, 8) and 16).

Tolerances:

* float32 forward and gradients, on unit-normal inputs:
  ``rtol=atol=1e-5``. Both sides compute in float32 and differ in
  summation order (XLA's conv against PyTorch's CPU conv; the JAX patch
  stem's 108-wide matmul against a 27-wide conv).
* float32 scoring, on uint8 pixels through ``center_128`` (inputs up to
  ±128, logits in the tens): ``SCALED_TOL = 1e-5`` of the output's
  largest magnitude. A sum-order error scales with the sums, not with
  each output.
* bfloat16 forward: ``BF16_STEPS = 2``, the error in units of one bf16
  step at the output's largest magnitude (2⁻⁷ of its power of two). The
  port adds each conv's and dense layer's bias inside the product, before
  the rounding to bf16, as the ViT's layers do; flax rounds the product
  and then adds the bias in bf16. So a layer's output may land a step
  apart, and the next layers carry that on. Measured on these inputs:
  1.94 steps (logits) and 1.38 (features); each side lies within 2.6
  steps of the float32 result.
* one conv with its bias against flax's ``nn.Conv``: ``rtol=atol=1e-5``
  in float32 (measured 0) and ``LAYER_BF16_STEPS = 1`` in bfloat16 (one
  rounding apart; measured 1 step).
* the trainer's loss histories and parameters: ``rtol=atol=1e-5``, as in
  ``tests/test_torch_train.py``.
* served answers against the port's offline ``TorchModel``:
  ``rtol=atol=1e-6``, the same module and float32 arithmetic with other
  rows packed beside each request.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

from mmlspark_tpu.models import bundle as jbundle  # noqa: E402
from mmlspark_tpu.models.jax_model import JaxModel  # noqa: E402
from mmlspark_tpu.models import zoo as jzoo  # noqa: E402
from mmlspark_tpu.data.table import DataTable as JaxTable  # noqa: E402
from mmlspark_tpu.ml import metrics as jmetrics  # noqa: E402
from mmlspark_tpu.train import loop as jloop  # noqa: E402
from mmlspark_tpu.train.preprocess import (  # noqa: E402
    DevicePreprocess as JaxPreprocess,
)
from mmlspark_tpu_torch.data.table import DataTable  # noqa: E402
from mmlspark_tpu_torch.ml.metrics import confusion_matrix  # noqa: E402
from mmlspark_tpu_torch.models import bundle as tbundle  # noqa: E402
from mmlspark_tpu_torch.models import convnet as tconv  # noqa: E402
from mmlspark_tpu_torch.models.convert import (  # noqa: E402
    _conv,
    convnet_state_dict_from_flax,
)
from mmlspark_tpu_torch.models.resnet import Conv  # noqa: E402
from mmlspark_tpu_torch.models.torch_model import TorchModel  # noqa: E402
from mmlspark_tpu_torch.models.zoo import get_model  # noqa: E402
from mmlspark_tpu_torch.ops import resize as rs_op  # noqa: E402
from mmlspark_tpu_torch.serve.config import ServeConfig  # noqa: E402
from mmlspark_tpu_torch.serve.server import ModelServer  # noqa: E402
from mmlspark_tpu_torch.train import loop as tloop  # noqa: E402
from mmlspark_tpu_torch.train import preprocess as tpre  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
SCALED_TOL = 1e-5
BF16_STEPS = 2
LAYER_BF16_STEPS = 1
SERVE_TOL = dict(rtol=1e-6, atol=1e-6)
SMALL = dict(widths=(8, 16), dense_width=32)
TRAIN_SMALL = dict(widths=(4, 8), dense_width=16)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NODES = ("features", "logits")
RUN = dict(batch_size=8, epochs=1, learning_rate=0.01, optimizer="momentum",
           log_every=1, seed=0)
# a spec without draws, so both trainers see the same batches
STANDARDIZE = dict(mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25))
DUMMY = jnp.zeros((1, 32, 32, 3), jnp.float32)


@functools.lru_cache(maxsize=None)
def _params(widths=SMALL["widths"], dense_width=SMALL["dense_width"]):
    """flax ConvNetCifar params as numpy arrays, made from seed 0 in the
    tree ``init`` would give (its shapes from an abstract init); cached,
    so callers must not mutate."""
    shapes = jax.eval_shape(
        jzoo.ConvNetCifar(widths=widths, dense_width=dense_width).init,
        jax.random.PRNGKey(0), DUMMY)["params"]
    r = np.random.default_rng(0)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * r.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class _NumpyInit(jzoo.ConvNetCifar):
    """The JAX ConvNet whose ``init`` returns :func:`_params` at its
    widths instead of drawing with flax's initializers."""

    @fnn.nowrap
    def init(self, rngs, *args, **kwargs):
        params = _params(tuple(self.widths), self.dense_width)
        return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _port(dtype):
    model = tconv.ConvNetCifar(dtype=dtype, device="cpu", **SMALL)
    model.load_state_dict(convnet_state_dict_from_flax(_params()))
    return model


def _jax_nodes(dtype, x, stem="direct"):
    """Both output nodes of the JAX module in one compiled call."""
    jm = jzoo.ConvNetCifar(dtype=dtype, stem=stem, **SMALL)
    both = jax.jit(lambda p, a: tuple(
        jm.apply({"params": p}, a, output=node) for node in NODES))
    return dict(zip(NODES, map(np.asarray, both(_params(), jnp.asarray(x)))))


def _images(n=4, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


def _tied_images():
    """Rows on the pooling's and the ReLU's ties: an all-zero image (each
    first conv's output is its bias at every pixel, so a channel with a
    negative bias sits at the ReLU's 0 and every window away from the
    border is tied), an image of constant 8×8 tiles (the first pooling's
    windows inside a tile hold equal values) and one with a zero half.
    Of the first pooling's 2048 windows, 2036, 1713, 1152 and 375 are
    tied on these rows, 756, 822 and 330 of them at positive values."""
    r = np.random.default_rng(1)
    tiles = np.repeat(np.repeat(r.normal(size=(4, 4, 3)), 8, 0), 8, 1)
    half = r.normal(size=(32, 32, 3))
    half[:, 16:] = 0.0
    return np.stack([np.zeros((32, 32, 3)), tiles, half,
                     _images(1, seed=2)[0]]).astype(np.float32)


def _bf16_steps(got, want):
    """The largest error in units of one bf16 step at the reference's
    largest magnitude."""
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / step)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_the_jax_convnet(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _images()
    want = _jax_nodes(jdt, x)
    model = _port(tdt)
    for node in NODES:
        with torch.no_grad():
            got = model(torch.from_numpy(x), output=node)
        assert got.dtype == torch.float32
        assert got.shape == want[node].shape == (
            4, 32 if node == "features" else 10)
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want[node], err_msg=node,
                                       **F32_TOL)
        else:
            assert _bf16_steps(got.numpy(), want[node]) <= BF16_STEPS, node


def test_patch_stem_checkpoint_matches_the_port():
    """The JAX patch stem (a space-to-depth matmul for every first conv
    with fewer than 32 input channels: conv0a and conv1a here) has the
    direct stem's parameters, so its checkpoints convert to the port's
    one ConvNet and give the same outputs in float32."""
    x = _images()
    want = _jax_nodes(jnp.float32, x, stem="patch")
    model = _port(torch.float32)
    for node in NODES:
        with torch.no_grad():
            got = model(torch.from_numpy(x), output=node).numpy()
        np.testing.assert_allclose(got, want[node], err_msg=node, **F32_TOL)


def test_patch_stem_params_convert_like_the_direct_stem():
    """Both JAX stems give the same parameter names and shapes, so one
    conversion and one port module serve either."""
    trees = [jax.eval_shape(
        jzoo.ConvNetCifar(stem=stem, **SMALL).init, jax.random.PRNGKey(0),
        DUMMY)["params"] for stem in ("direct", "patch")]
    direct, patch = (convnet_state_dict_from_flax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), t)) for t in trees)
    port = tconv.ConvNetCifar(device="cpu", **SMALL).state_dict()
    assert {k: v.shape for k, v in direct.items()} == \
        {k: v.shape for k, v in patch.items()} == \
        {k: v.shape for k, v in port.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_with_bias_matches_flax_conv(dtype):
    """The port's 3×3 conv with its bias inside the call against flax's
    ``nn.Conv(features, (3, 3))``, which adds the bias to the rounded
    product."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(12)
    x = r.normal(size=(2, 8, 8, 5)).astype(np.float32)
    params = {"kernel": (r.normal(size=(3, 3, 5, 7)) / np.sqrt(45)).astype(
        np.float32), "bias": (0.1 * r.normal(size=7)).astype(np.float32)}
    want = np.asarray(jax.jit(
        lambda p, a: fnn.Conv(7, (3, 3), dtype=jdt).apply({"params": p}, a))(
            params, jnp.asarray(x)), np.float32)
    conv = Conv(5, 7, 3, 1, tdt, device="cpu", bias=True)
    weights = {}
    _conv(params, "conv", weights)
    conv.load_state_dict({"weight": weights["conv.weight"],
                          "bias": torch.from_numpy(params["bias"])})
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert _bf16_steps(got, want) <= LAYER_BF16_STEPS


def test_conv_has_a_bias_only_when_asked():
    """The ResNet's convs keep their bias-free state dict."""
    assert list(Conv(3, 4, 3, 1, torch.float32, device="cpu")
                .state_dict()) == ["weight"]
    assert list(Conv(3, 4, 3, 1, torch.float32, device="cpu", bias=True)
                .state_dict()) == ["weight", "bias"]


def test_unknown_output_node_raises():
    with pytest.raises(ValueError, match="unknown output node"):
        _port(torch.float32)(torch.zeros(1, 32, 32, 3), output="conv2b")


def test_init_convnet_is_seeded():
    """Every kernel drawn from the generator, every bias zero; the same
    seed gives the same weights and another seed others."""
    def build(seed):
        model = tconv.ConvNetCifar(dtype=torch.float32, device="cpu",
                                   **SMALL)
        return tconv.init_convnet_(
            model, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        if k.endswith(".bias"):
            assert not a[k].any(), k
        else:
            assert a[k].std() > 0 and not torch.equal(a[k], c[k]), k


@pytest.mark.parametrize("inputs", ["random", "tied"])
def test_gradients_match_jax_vjp(inputs):
    """Every parameter's and the input's gradient in float32, for a
    cotangent on the logits, against ``jax.vjp``; the tied rows put whole
    pooling windows on the ReLU's zero and on equal positive values."""
    x = _images() if inputs == "random" else _tied_images()
    jm = jzoo.ConvNetCifar(dtype=jnp.float32, **SMALL)
    cot = np.random.default_rng(3).normal(size=(len(x), 10)).astype(
        np.float32)

    @jax.jit
    def grads(p, a, c):
        return jax.vjp(lambda p, a: jm.apply({"params": p}, a), p, a)[1](c)

    gp, gx = grads(_params(), jnp.asarray(x), jnp.asarray(cot))
    want = convnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, gp))
    model = _port(torch.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    model(xt).backward(torch.from_numpy(cot))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **F32_TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_max_pool_ties_go_to_the_first_maximum(dtype):
    """``F.max_pool2d`` on the NHWC activation's channels-last view sends
    a tied window's gradient where ``jax.vjp`` of ``nn.max_pool`` does:
    to its first maximum in row-major order."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(4)
    x = r.integers(0, 2, (2, 6, 8, 5)).astype(np.float32)  # many ties
    x[0, :2, :2] = 0.0                                     # all-zero windows
    cot = r.normal(size=(2, 3, 4, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: fnn.max_pool(a, (2, 2), strides=(2, 2)),
                     jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(cot, jdt))[0], np.float32)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = torch.nn.functional.max_pool2d(xt.permute(0, 3, 1, 2), 2, 2)
    y.permute(0, 2, 3, 1).backward(torch.from_numpy(cot).to(tdt))
    got = xt.grad.float().numpy()
    np.testing.assert_array_equal(got, want)
    # each window's gradient lies on one element, the first of its maxima
    assert (np.count_nonzero(got) == np.count_nonzero(cot))


def test_center_128_matches_jax():
    x = np.random.default_rng(5).integers(0, 256, (3, 4, 4, 3)).astype(
        np.float32)
    want = np.asarray(jbundle.PREPROCESSORS["center_128"](jnp.asarray(x)))
    got = tbundle.PREPROCESSORS["center_128"](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_confusion_matrix_matches_jax_and_drops_out_of_range_codes():
    r = np.random.default_rng(6)
    y = r.integers(-1, 5, 200)          # -1: the unseen sentinel; 4 == k
    pred = r.integers(-1, 5, 200)
    got = confusion_matrix(y, pred, 4)
    np.testing.assert_array_equal(got, jmetrics.confusion_matrix(y, pred, 4))
    valid = (y >= 0) & (y < 4) & (pred >= 0) & (pred < 4)
    assert got.dtype == np.int64 and got.sum() == valid.sum() < len(y)
    assert confusion_matrix(np.array([3, -1]), np.array([-1, 3]), 4).sum() \
        == 0


def test_zoo_entry_builds_the_full_width_model():
    bundle = get_model("ConvNet_CIFAR10", device="cpu")
    assert bundle.name == "ConvNet_CIFAR10"
    assert bundle.input_spec == (32, 32, 3)
    assert bundle.output_names == jzoo.ConvNetCifar.OUTPUT_NAMES == NODES
    assert bundle.preprocess == "center_128"
    module = bundle.module
    assert module.widths == (128, 256, 512) and module.dense_width == 512
    assert module.compute_dtype == torch.bfloat16
    # the converted JAX parameters fill it, shape for shape (the JAX
    # bundle's spec and preprocess are init_bundle's arguments in
    # conv_net_cifar; its shapes come from an abstract init)
    shapes = jax.eval_shape(jzoo.ConvNetCifar().init,
                            jax.random.PRNGKey(0), DUMMY)["params"]
    want = convnet_state_dict_from_flax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    got = module.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    # truncated LeCun-normal kernels, zero biases
    w, fan_in = got["conv1b.weight"], 9 * 256
    std = (1.0 / fan_in) ** 0.5
    assert float(w.abs().max()) <= 2 * std / tconv._TRUNC_STD
    assert 0.9 < float(w.std()) / std < 1.1
    assert not any(got[k].any() for k in got if k.endswith(".bias"))


def test_zoo_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("ConvNet_CIFAR10")


def _train_data():
    r = np.random.default_rng(7)
    x = r.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8)
    y = r.integers(0, 10, 20).astype(np.int64)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(initial params, loss history, final params) of the JAX trainer,
    params as the port's state dict."""
    x, y = _train_data()
    trainer = jloop.Trainer(
        _NumpyInit(dtype=jnp.float32, **TRAIN_SMALL),
        jloop.TrainConfig(preprocess=JaxPreprocess(**STANDARDIZE),
                          mesh_spec={"dp": 1}, **RUN))
    trainer.state = trainer.init_state(x.shape[1:])
    init = convnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    trainer.fit_arrays(x, y)
    final = convnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    return init, list(trainer.history), final


def test_fit_arrays_matches_the_jax_trainer():
    init, want_history, want_params = _jax_run()
    module = tconv.ConvNetCifar(dtype=torch.float32, device="cpu",
                                **TRAIN_SMALL)
    cfg = tloop.TrainConfig(device="cpu",
                            preprocess=tpre.DevicePreprocess(**STANDARDIZE),
                            **RUN)
    trainer = tloop.Trainer(module, cfg, initial_state_dict=init)
    trainer.fit_arrays(*_train_data())
    assert trainer.global_step == 3 and len(trainer.history) == 3
    np.testing.assert_allclose(trainer.history, want_history, **F32_TOL)
    got = trainer.state_dict()
    assert set(got) == set(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                   err_msg=k, **F32_TOL)
    # the run moved the weights well past the tolerance
    assert max(float((want_params[k] - init[k]).abs().max())
               for k in init) > 100 * F32_TOL["atol"]


def test_cifar_spec_trains_without_the_resize_kernel(monkeypatch):
    """The repo's CIFAR setup (crop_pad 4, flips, brightness, contrast;
    no resize) takes the plain cast for its geometry: neither the resize
    kernel's wrapper nor its launch counter is reached."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return rs_op.fused_resize_norm(*args, **kwargs)

    monkeypatch.setattr(tpre, "fused_resize_norm", counted)
    monkeypatch.setattr(rs_op, "launches", 0)
    spec = tpre.DevicePreprocess(crop_pad=4, flip_lr=True, brightness=0.1,
                                 contrast=(0.9, 1.1))
    module = get_model("ConvNet_CIFAR10", device="cpu", **TRAIN_SMALL).module
    cfg = tloop.TrainConfig(device="cpu", preprocess=spec, **RUN)
    trainer = tloop.Trainer(module, cfg).fit_arrays(*_train_data())
    assert len(trainer.history) == 3
    assert all(np.isfinite(trainer.history))
    assert calls == [] and rs_op.launches == 0


def _scoring_models(node):
    jb = jbundle.ModelBundle(
        module=jzoo.ConvNetCifar(dtype=jnp.float32, **SMALL),
        params=jax.tree_util.tree_map(jnp.asarray, _params()),
        input_spec=(32, 32, 3), output_names=NODES,
        preprocess="center_128", name="ConvNet_CIFAR10")
    port = get_model("ConvNet_CIFAR10", device="cpu", dtype=torch.float32,
                     **SMALL)
    port.module.load_state_dict(convnet_state_dict_from_flax(_params()))
    return jb, TorchModel(model=port, input_col="image", output_col="out",
                          output_node=node, minibatch_size=4, device="cpu")


def _flat_rows(n, seed):
    return list(np.random.default_rng(seed).integers(
        0, 256, (n, 32 * 32 * 3), dtype=np.uint8))


@pytest.mark.parametrize("node", NODES)
def test_torch_model_scores_as_jax_model(node):
    """Flat uint8 rows of 3072 values, coerced to (32, 32, 3), through
    the bundle's center_128 and the given node, in minibatches with a
    padded tail."""
    jb, model = _scoring_models(node)
    rows = _flat_rows(10, seed=8)
    want = np.stack(JaxModel(model=jb, input_col="image", output_col="out",
                             output_node=node, minibatch_size=4)
                    .transform(JaxTable({"image": rows}))["out"])
    got = np.stack(model.transform(DataTable({"image": rows}))["out"])
    assert got.shape == want.shape == (10, 32 if node == "features" else 10)
    assert np.abs(got - want).max() <= SCALED_TOL * np.abs(want).max()


def test_served_answers_match_torch_model():
    """The bundle served through ``ModelServer.add_model``: single-row
    requests answered as the offline ``TorchModel`` answers them."""
    _, model = _scoring_models("logits")
    rows = _flat_rows(6, seed=9)
    offline = np.stack(model.transform(DataTable({"image": rows}))["out"])
    with ModelServer(ServeConfig(buckets=(1, 4))) as server:
        server.add_model("cifar", model,
                         example=DataTable({"image": rows[:1]}))
        handles = [server.submit("cifar", DataTable({"image": [row]}))
                   for row in rows]
        got = np.concatenate([np.stack(h.result(timeout=60)["out"])
                              for h in handles])
    np.testing.assert_allclose(got, offline, **SERVE_TOL)
