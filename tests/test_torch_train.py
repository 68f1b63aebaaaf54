"""The port's single-device trainer (mmlspark_tpu_torch/train/) against the
JAX package's.

The same ``resnet18_thin`` weights (flax init, converted) train on the
same 20 uint8 40×40 rows at batch 8 (two full batches and a zero-padded
tail of 4 real rows), with a deterministic spec (bilinear resize to 32²,
no stochastic stage), momentum SGD and ``log_every=1``: the port's
``Trainer.fit_arrays`` on CPU tensors (plain GroupNorm and resize) and
the JAX package's ``Trainer.fit_arrays`` on one CPU device (GroupNorm
through XLA).

Tolerances:

* loss histories and parameters after the run: ``rtol=atol=1e-5``. Both
  sides compute in float32 and differ in summation order and in the
  variance form of the GroupNorm (flax's one-pass, the port's centred):
  measured 9.5e-7 on losses near 3 and 1.2e-7 on parameters;
* optimizers against optax on fixed gradients: ``rtol=1e-6, atol=1e-7``
  for SGD and momentum, the same float32 update rounded in another order;
  ``rtol=2e-5`` for Adam and AdamW: optax forms the bias correction
  ``1 − β₂ᵗ`` in float32, where β₂ = 0.999 rounds to 0.99900001 and
  ``1 − β₂`` is 1.3e-5 off, PyTorch in float64, so their steps differ by
  up to 7.4e-6 relative (measured);
* losses against the JAX package's: ``rtol=atol=1e-6``.
"""

import functools
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from mmlspark_tpu.models import resnet as jres  # noqa: E402
from mmlspark_tpu.train import loop as jloop  # noqa: E402
from mmlspark_tpu.train.preprocess import (  # noqa: E402
    DevicePreprocess as JaxPreprocess,
)
from mmlspark_tpu_torch.models import resnet as tres  # noqa: E402
from mmlspark_tpu_torch.models.convert import (  # noqa: E402
    resnet_state_dict_from_flax,
)
from mmlspark_tpu_torch.train import input as tinput  # noqa: E402
from mmlspark_tpu_torch.train import loop as tloop  # noqa: E402
from mmlspark_tpu_torch.train.anomaly import NonFiniteLossError  # noqa: E402
from mmlspark_tpu_torch.train.preprocess import DevicePreprocess  # noqa: E402

TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
ADAM_TOL = dict(rtol=2e-5, atol=1e-7)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
RUN = dict(batch_size=8, epochs=1, learning_rate=0.01, optimizer="momentum",
           log_every=1, seed=0)
LOADER_THREADS = tinput.THREAD_PREFIX


def _data():
    r = np.random.default_rng(0)
    x = r.integers(0, 256, (20, 40, 40, 3), dtype=np.uint8)
    y = r.integers(0, 10, 20).astype(np.int64)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(initial params, loss history, final params) of the JAX trainer,
    params as the port's state dict."""
    x, y = _data()
    trainer = jloop.Trainer(
        jres.resnet18_thin(num_classes=10, dtype=jnp.float32),
        jloop.TrainConfig(preprocess=JaxPreprocess(resize=(32, 32)),
                          mesh_spec={"dp": 1}, **RUN))
    trainer.state = trainer.init_state(x.shape[1:])
    init = resnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    trainer.fit_arrays(x, y)
    final = resnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    return init, list(trainer.history), final


def _seeded_model():
    model = tres.resnet18_thin(num_classes=10, dtype=torch.float32,
                               device="cpu")
    return tres.init_resnet_(model, torch.Generator().manual_seed(0))


def _port_trainer(depth=2, **kw):
    kw = {**RUN, "preprocess": DevicePreprocess(resize=(32, 32)), **kw}
    cfg = tloop.TrainConfig(device="cpu", prefetch_depth=depth, **kw)
    model = tres.resnet18_thin(num_classes=10, dtype=torch.float32,
                               device="cpu")
    return tloop.Trainer(model, cfg, initial_state_dict=_jax_run()[0])


def test_fit_arrays_matches_the_jax_trainer(assert_no_leaked_threads):
    init, want_history, want_params = _jax_run()
    trainer = _port_trainer().fit_arrays(*_data())
    assert trainer.global_step == 3 and len(trainer.history) == 3
    np.testing.assert_allclose(trainer.history, want_history, **TRAIN_TOL)
    got = trainer.state_dict()
    assert set(got) == set(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                   err_msg=k, **TRAIN_TOL)
    # the run moved the weights well past the tolerance
    assert max(float((want_params[k] - init[k]).abs().max())
               for k in init) > 100 * TRAIN_TOL["atol"]
    stats = trainer.input_stats
    assert stats["batches"] == 3 and stats["prefetch_depth"] == 2
    assert 0.0 <= stats["input_bound_fraction"] <= 1.0
    assert_no_leaked_threads(LOADER_THREADS)


def test_prefetch_depth_is_bit_identical():
    runs = [_port_trainer(depth=d).fit_arrays(*_data()) for d in (0, 2)]
    assert runs[0].history == runs[1].history
    a, b = (r.state_dict() for r in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_stochastic_spec_replays_its_draws_at_every_depth():
    spec = DevicePreprocess(src_crop=(36, 36), resize=(32, 32), crop_pad=2,
                            flip_lr=True, brightness=0.1,
                            contrast=(0.9, 1.1))
    runs = [_port_trainer(depth=d, preprocess=spec).fit_arrays(*_data())
            for d in (0, 1)]
    assert runs[0].history == runs[1].history
    assert all(np.isfinite(runs[0].history))


def test_nan_input_raises_and_leaves_no_loader_thread(
        assert_no_leaked_threads):
    x = np.random.default_rng(1).random((16, 32, 32, 3)).astype(np.float32)
    x[5, 3, 3, 0] = np.nan
    y = np.zeros(16, np.int64)
    cfg = tloop.TrainConfig(device="cpu", **RUN)
    trainer = tloop.Trainer(
        _seeded_model(), cfg)
    with pytest.raises(NonFiniteLossError) as err:
        trainer.fit_arrays(x, y)
    assert err.value.step in (1, 2) and not np.isfinite(err.value.value)
    assert_no_leaked_threads(LOADER_THREADS)


def test_nan_loss_in_event_mode_is_recorded_and_training_goes_on():
    x = np.full((8, 32, 32, 3), np.nan, np.float32)
    cfg = tloop.TrainConfig(device="cpu", nonfinite_loss="event", **RUN)
    trainer = tloop.Trainer(
        _seeded_model(), cfg)
    trainer.fit_arrays(x, np.zeros(8, np.int64))
    assert len(trainer.history) == 1 and np.isnan(trainer.history[0])
    with pytest.raises(ValueError, match="nonfinite_loss"):
        tloop.Trainer(_seeded_model(),
                      tloop.TrainConfig(device="cpu", nonfinite_loss="warn"))


def test_zero_weight_rows_train_as_no_ops():
    """A batch whose every row has weight 0 (the padded tail's filler)
    changes nothing: the loss is 0 and so is every gradient."""
    trainer = tloop.Trainer(
        _seeded_model(),
        tloop.TrainConfig(device="cpu", optimizer="sgd", learning_rate=1.0))
    before = {k: v.clone() for k, v in trainer.state_dict().items()}
    x = torch.rand(4, 32, 32, 3)
    loss = trainer.train_step(x, torch.zeros(4, dtype=torch.int64),
                              torch.zeros(4))
    assert float(loss) == 0.0
    after = trainer.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_follow_optax(name):
    r = np.random.default_rng(2)
    p0 = r.normal(size=(5, 3)).astype(np.float32)
    grads = [r.normal(size=p0.shape).astype(np.float32) for _ in range(4)]
    cfg = tloop.TrainConfig(optimizer=name, learning_rate=0.05,
                            weight_decay=0.1 if name == "adamw" else 0.0)
    tx = jloop.make_optimizer(cfg)
    params = jnp.asarray(p0)
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tloop.make_optimizer(cfg, [p])
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               **(ADAM_TOL if "adam" in name else OPT_TOL))
    with pytest.raises(ValueError, match="optimizer"):
        tloop.make_optimizer(tloop.TrainConfig(optimizer="lamb"), [p])


def _token_mask(r, b, n):
    # right-padded rows of lengths 1..n, one of them a full row
    lengths = r.integers(1, n + 1, b)
    lengths[0] = n
    return (np.arange(n)[None, :] < lengths[:, None]).astype(np.float32)


# case -> (logits shape, labels, token mask or None). The per-token cases
# put the class axis last ([B, L, C], as the JAX package's losses read it);
# L == C is the case where an axis-1 class reading gives a loss of the
# right shape and the wrong value
LOSS_CASES = {
    "softmax_xent": ((6, 5), lambda r: r.integers(0, 5, 6), None),
    "softmax_xent_per_token": ((6, 7, 5), lambda r: r.integers(0, 5, (6, 7)),
                               None),
    "softmax_xent_per_token_square": (
        (6, 5, 5), lambda r: r.integers(0, 5, (6, 5)), None),
    "softmax_xent_per_token_masked": (
        (6, 7, 5), lambda r: r.integers(0, 5, (6, 7)),
        lambda r: _token_mask(r, 6, 7)),
    "softmax_xent_per_token_square_masked": (
        (6, 5, 5), lambda r: r.integers(0, 5, (6, 5)),
        lambda r: _token_mask(r, 6, 5)),
    "sigmoid_xent": ((6, 1), lambda r: r.integers(0, 2, 6), None),
    "sigmoid_xent_multilabel": ((6, 4), lambda r: r.integers(0, 2, (6, 4)),
                                None),
    "sigmoid_xent_per_token_masked": (
        (6, 7, 4), lambda r: r.integers(0, 2, (6, 7, 4)),
        lambda r: _token_mask(r, 6, 7)),
    "mse": ((6, 1), lambda r: r.normal(size=6), None),
    "mse_multitarget": ((6, 3), lambda r: r.normal(size=(6, 3)), None),
    "mse_per_token_masked": ((6, 7, 1), lambda r: r.normal(size=(6, 7)),
                             lambda r: _token_mask(r, 6, 7)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_the_jax_packages(case):
    kind = case.split("_multi")[0].split("_per_token")[0]
    shape, labels, token_mask = LOSS_CASES[case]
    r = np.random.default_rng(3)
    logits = r.normal(size=shape).astype(np.float32)
    y = labels(r).astype(np.float32 if kind != "softmax_xent" else np.int64)
    jkw, tkw = {}, {}
    if token_mask is not None:
        tm = token_mask(r)
        jkw["token_mask"] = jnp.asarray(tm)
        tkw["token_mask"] = torch.from_numpy(tm)
    want = np.asarray(jloop.make_loss(kind)(jnp.asarray(logits),
                                            jnp.asarray(y), **jkw))
    got = tloop.make_loss(kind)(torch.from_numpy(logits),
                                torch.from_numpy(y), **tkw).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_a_token_mask_that_does_not_tile_the_loss_raises():
    loss = tloop.make_loss("softmax_xent")
    with pytest.raises(ValueError, match="does not tile"):
        loss(torch.zeros(2, 5, 3), torch.zeros(2, 5, dtype=torch.long),
             token_mask=torch.ones(2, 4))


@pytest.mark.parametrize("n,bs", [(20, 8), (16, 8), (3, 5)])
def test_batches_walk_the_jax_packages_batches(n, bs):
    r = np.random.default_rng(4)
    x = r.integers(0, 256, (n, 2, 2, 1), dtype=np.uint8)
    y = r.integers(0, 3, n)
    port = list(tloop._batches(x, y, bs, seed=7))
    ref = list(jloop._batches(x, y, bs, seed=7))
    assert len(port) == len(ref) == -(-n // bs)
    for a, b in zip(port, ref):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def test_loader_prefetches_in_order_and_relays_errors(
        assert_no_leaked_threads):
    items = list(range(7))
    for depth in (0, 1, 3):
        loader = tinput.DeviceLoader(iter(items), lambda i: i * 10,
                                     depth=depth, name="order")
        assert list(loader) == [i * 10 for i in items]
        assert loader.consumed == loader.committed == 7
        loader.close()

    def broken():
        yield 1
        raise RuntimeError("source failed")

    loader = tinput.DeviceLoader(broken(), lambda i: i, depth=2,
                                 name="broken")
    assert next(loader) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(loader)
    assert_no_leaked_threads(LOADER_THREADS)


def test_loader_closed_mid_walk_stops_its_thread(assert_no_leaked_threads):
    loader = tinput.DeviceLoader(iter(range(100)), lambda i: i, depth=2,
                                 name="early-exit")
    assert threading.active_count() >= 2
    assert [next(loader) for _ in range(3)] == [0, 1, 2]
    loader.close()
    loader.close()  # idempotent
    assert_no_leaked_threads(LOADER_THREADS)
    stats = tinput.input_stats(loader, 1.0)
    assert stats["batches"] == 3 and stats["prefetch_depth"] == 2


def test_host_to_device_on_the_cpu_keeps_the_arrays():
    h2d = tinput.HostToDevice(torch.device("cpu"))
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = h2d([a, a[:, ::-1]]).ready()
    assert out[0].device.type == "cpu"
    np.testing.assert_array_equal(out[1].numpy(), a[:, ::-1])


def test_fit_arrays_refuses_a_geometry_the_spec_cannot_take():
    trainer = tloop.Trainer(
        _seeded_model(),
        tloop.TrainConfig(device="cpu",
                          preprocess=DevicePreprocess(src_crop=(48, 48))))
    x = np.zeros((4, 40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="src_crop"):
        trainer.fit_arrays(x, np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="rows"):
        trainer.fit_arrays(x, np.zeros(3, np.int64))
