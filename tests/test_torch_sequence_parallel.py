"""Sequence-parallel training of the causal TransformerTagger: the port's
``Trainer`` with ``mesh_spec={"sp": 4}`` (ring attention over four virtual
ranks on one device) against the JAX package's ``Trainer`` with
``MeshSpec(dp=1, sp=4)`` (ring attention under ``shard_map`` on four of the
eight virtual CPU devices), and the sequence helpers against the JAX
package's.

The same tiny causal tagger (``pad_token_id=0``; flax init, converted with
``sequence_state_dict_from_flax``) trains with plain SGD on the same
next-token batches: 10 right-padded sequences of 4–32 tokens at batch 4, so
most rows leave rank 3's block pad only, and the third batch is the
zero-padded tail (two all-pad rows of weight 0).

Tolerances, absolute: losses 1e-5 (about 1e-6 of a loss near ln 61 = 4.1;
both sides run the same float32 recurrence and differ in the summation
order of the matrix products); parameters after the first step 1e-5 (the
update is 0.1 × a gradient that carries the same rounding).
"""

import types

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models import sequence as tseq
from mmlspark_tpu_torch.models.convert import sequence_state_dict_from_flax
from mmlspark_tpu_torch.models.resnet import resnet18_thin
from mmlspark_tpu_torch.parallel.mesh import make_mesh
from mmlspark_tpu_torch.train import loop as tloop

jax = pytest.importorskip("jax")

from mmlspark_tpu.models import sequence as jseq  # noqa: E402
from mmlspark_tpu.parallel.mesh import MeshSpec  # noqa: E402
from mmlspark_tpu.train import loop as jloop  # noqa: E402

ATOL = 1e-5
KW = dict(vocab_size=61, embed_dim=32, num_heads=4, num_layers=2,
          mlp_dim=64, num_tags=61, max_len=32, causal=True, pad_token_id=0)
RUN = dict(batch_size=4, epochs=1, learning_rate=0.1, optimizer="sgd",
           log_every=1, seed=0)
L = 32


def _next_token_data(rows, seed=0):
    """Sequences of n+1 tokens in [1, vocab) with n in 4..L: x the first n,
    y the last n, both right-padded with 0 to L."""
    r = np.random.default_rng(seed)
    x = np.zeros((rows, L), np.int64)
    y = np.zeros((rows, L), np.int64)
    for i, n in enumerate(r.integers(4, L + 1, rows)):
        s = r.integers(1, KW["vocab_size"], n + 1)
        x[i, :n], y[i, :n] = s[:-1], s[1:]
    return x, y


@pytest.fixture(scope="module")
def run():
    """Both trainers over the same weights and batches: loss histories,
    and the parameters after the first step."""
    x, y = _next_token_data(10)
    jt = jloop.Trainer(jseq.TransformerTagger(**KW),
                       jloop.TrainConfig(mesh_spec=MeshSpec(dp=1, sp=4),
                                         **RUN))
    state = jt.init_state(x.shape[1:])
    init = jax.tree_util.tree_map(np.asarray, state["params"])
    jt.state = state
    jt.fit_arrays(x, y)
    first = next(jloop._batches(x, y, RUN["batch_size"], RUN["seed"]))
    state, _ = jt.step_masked(jt.init_state(x.shape[1:]), *first)
    j_step1 = sequence_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state["params"]))

    sd = sequence_state_dict_from_flax(init)
    cfg = tloop.TrainConfig(mesh_spec={"sp": 4}, device="cpu", **RUN)
    tt = tloop.Trainer(tseq.TransformerTagger(device="cpu", **KW), cfg,
                       initial_state_dict=sd).fit_arrays(x, y)
    t1 = tloop.Trainer(tseq.TransformerTagger(device="cpu", **KW), cfg,
                       initial_state_dict=sd)
    t1.train_step(*(torch.from_numpy(a) for a in first))
    return dict(x=x, y=y, first=first, sd=sd, jax_history=jt.history,
                port_history=tt.history, jax_step1=j_step1,
                port_step1=t1.state_dict())


def test_sp_trainer_losses_match_the_jax_trainer(run):
    assert len(run["port_history"]) == len(run["jax_history"]) == 3
    assert np.isfinite(run["port_history"]).all()
    np.testing.assert_allclose(run["port_history"], run["jax_history"],
                               rtol=0, atol=ATOL)


def test_sp_trainer_parameters_after_one_step_match(run):
    bx = run["first"][0]
    # the first batch has rows whose rank-3 block (positions 24-31) is
    # pad only
    assert (bx[:, 24:] == 0).all(axis=1).any()
    want, got = run["jax_step1"], run["port_step1"]
    assert set(want) == set(got)
    for name in want:
        assert torch.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=ATOL, err_msg=name)
    moved = [n for n in got if not torch.equal(got[n], run["sd"][n])]
    assert len(moved) == len(got)


def test_gradients_stay_finite_on_pad_only_ranks_and_rows():
    x, y = _next_token_data(4, seed=3)
    x[1, 8:] = y[1, 8:] = 0             # ranks 1-3 of row 1 are pad only
    # row 3 is pad only (weight 0): every one of its query rows is fully
    # masked on every hop
    x[3] = y[3] = 0
    w = np.array([1, 1, 1, 0], np.float32)
    model = tseq.TransformerTagger(device="cpu", **KW)
    tseq.init_sequence_(model, torch.Generator().manual_seed(0))
    trainer = tloop.Trainer(model, tloop.TrainConfig(
        mesh_spec={"sp": 4}, device="cpu", **RUN))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = trainer.train_step(*(torch.from_numpy(a) for a in (x, y, w)))
    assert torch.isfinite(loss)
    for p in model.parameters():
        assert torch.isfinite(p.grad).all()
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
    # an all-pad batch of weight 0 trains as an exact no-op
    trainer.optimizer.zero_grad()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    zero = torch.zeros(4, L, dtype=torch.long)
    trainer.train_step(zero, zero, torch.zeros(4))
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert any(not torch.equal(state[k], before[k]) for k in state)


def test_ring_forward_matches_the_unsharded_forward_and_flax():
    x, _ = _next_token_data(4, seed=5)
    jm = jseq.TransformerTagger(**KW)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), np.zeros((1, L), np.int32))["params"])
    model = tseq.TransformerTagger(device="cpu", **KW)
    model.load_state_dict(sequence_state_dict_from_flax(params))
    hooks = model.mesh_hooks(make_mesh({"sp": 4}, "cpu"))
    assert hooks["handled"] == {"sp"}
    with torch.no_grad():
        tokens = torch.from_numpy(x)
        ring = model(tokens, **hooks["apply_kwargs"])
        plain = model(tokens)
    # the pad mask comes from pad_token_id when none is passed
    want = np.asarray(jm.apply({"params": params}, x.astype(np.int32)))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ring.numpy(), plain.numpy(), rtol=0,
                               atol=ATOL)
    assert model.mesh_hooks(make_mesh({"dp": 2}, "cpu"))["handled"] == set()


def test_unused_mesh_axes_raise_as_in_the_jax_package():
    module = resnet18_thin(device="cpu")
    for axis in ("sp", "pp", "ep"):
        with pytest.raises(ValueError, match="silently replicate"):
            tloop.Trainer(module, tloop.TrainConfig(
                mesh_spec={"dp": 2, axis: 4}, device="cpu"))
    tagger = tseq.TransformerTagger(device="cpu", **KW)
    with pytest.raises(ValueError, match="silently replicate"):
        tloop.Trainer(tagger, tloop.TrainConfig(mesh_spec={"ep": 2},
                                                device="cpu"))
    for shape, handled in (({"dp": 2, "sp": 2, "pp": 1, "ep": 3}, {"sp"}),
                           ({"dp": 1, "sp": 4, "pp": 2, "ep": 1}, set()),
                           ({"dp": 8, "sp": 1, "pp": 1, "ep": 1}, set())):
        mesh = types.SimpleNamespace(shape=shape)
        errors = []
        for fn in (jloop.check_mesh_axes_used, tloop.check_mesh_axes_used):
            try:
                fn(module, mesh, handled)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e).split(" have extent")[0])
        assert errors[0] == errors[1]


@pytest.mark.parametrize("axis", ["fsdp", "tp"])
def test_axes_that_are_not_ported_raise(axis):
    tagger = tseq.TransformerTagger(device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="not ported"):
        tloop.Trainer(tagger, tloop.TrainConfig(mesh_spec={axis: 2},
                                                device="cpu"))


def test_dp_rounds_the_batch_down_and_changes_no_number():
    x, y = _next_token_data(6, seed=7)
    sd = tseq.init_sequence_(tseq.TransformerTagger(device="cpu", **KW),
                             torch.Generator().manual_seed(2)).state_dict()
    hist = []
    for spec, bs in (({"dp": 2, "sp": 2}, 5), ({"sp": 2}, 4)):
        cfg = tloop.TrainConfig(mesh_spec=spec, device="cpu",
                                **{**RUN, "batch_size": bs})
        t = tloop.Trainer(tseq.TransformerTagger(device="cpu", **KW), cfg,
                          initial_state_dict=sd).fit_arrays(x, y)
        hist.append(t.history)
    assert len(hist[0]) == 2
    np.testing.assert_allclose(hist[0], hist[1], rtol=0, atol=1e-6)


def _seqs(seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 50, n).tolist() for n in r.integers(1, 40, 13)]


def test_pad_sequences_and_bucket_batches_match_the_jax_packages():
    seqs = _seqs(0)
    for a, b in zip(tseq.pad_sequences(seqs, 40, pad_value=0),
                    jseq.pad_sequences(seqs, 40, pad_value=0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = list(tseq.bucket_batches(seqs, 3, bucket_sizes=(16, 8, 64)))
    want = list(jseq.bucket_batches(seqs, 3, bucket_sizes=(16, 8, 64)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad,exc", [
    ([[1, 2], []], ValueError),
    ([[1, 2], [[1, 2]]], ValueError),
    ([[1.5, 2.0]], TypeError),
    ([["a", "b"]], TypeError),
    ([list(range(70))], ValueError),
])
def test_sequence_helpers_raise_as_in_the_jax_package(bad, exc):
    for mod in (tseq, jseq):
        with pytest.raises(exc):
            list(mod.bucket_batches(bad, 2, bucket_sizes=(8, 64)))
        with pytest.raises(exc):
            mod.pad_sequences(bad, 64)
