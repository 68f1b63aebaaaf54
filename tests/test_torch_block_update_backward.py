"""The backward of the ring-hop block update (mmlspark_tpu_torch/ops/
attention.py): the closed form ``block_update_backward_reference`` against
``jax.vjp`` of the JAX package's ``attention_block_update`` (``impl="xla"``,
the shared ``_online_update`` vmapped, which JAX training differentiates
through XLA) and against the port's autograd route, on numpy-seeded inputs;
its error bound; and the kernel route's ``autograd.Function`` through one
sequence-parallel training step.

Tolerance 1e-5 absolute (``ATOL``, as ``tests/test_torch_block_update.py``
holds the gradients): both sides compute in float32 from the same operands
and differ in the summation order of the products (XLA's or autograd's
against PyTorch's), a few 1e-7 on gradients of order 1 to 10 at these
sizes. The max's term is discontinuous in the scores: where two
evaluations may see a tie differently, the inputs are integers, so that
every score is exact on both sides and the ties are the same.

The CUDA kernel runs only on a card: its test is marked ``cuda`` and skips
here (``chip_smoke.py`` holds it against the closed form at every hop of the
ring's geometry).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import attention as ta

ATOL = 1e-5
# the error bound's multiple of float32's epsilon, as chip_smoke.py
# BLOCK_BWD_REL
REL = 64 * 2.0 ** -23
NAMES = ("dq", "dk", "dv", "dm", "ddenom", "dacc")


def _jax():
    """jax, jax.numpy and the JAX package's attention module, imported only
    by the tests that compare with them (the card's machine has no JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from mmlspark_tpu.ops.pallas import attention as ja
    return jax, jnp, ja


def _inputs(n, h, tq, tk, d, keep_kind, carry, seed, integer=False):
    """numpy q, k, v, keep and a carry. ``carry``: "init" (-inf/0/0) or
    "hop" (one plain update over another block, rows 0-1 still unseen).
    ``integer``: q and k in {-1, 0, 1}, so every score is an exact
    integer before the scale (and ties are common)."""
    r = np.random.default_rng(seed)
    if integer:
        q, k = (r.integers(-1, 2, size=(n, h, t, d)).astype(np.float32)
                for t in (tq, tk))
    else:
        q, k = (r.normal(size=(n, h, t, d)).astype(np.float32)
                for t in (tq, tk))
    v = r.normal(size=(n, h, tk, d)).astype(np.float32)
    if keep_kind == "holes":
        keep = r.random((n, tq, tk)) > 0.3
        keep[0, 1] = False               # one query row with no key here
    elif keep_kind == "causal":
        keep = np.broadcast_to(np.tril(np.ones((tq, tk), bool)),
                               (n, tq, tk)).copy()
    elif keep_kind == "all":
        keep = np.ones((n, tq, tk), bool)
    else:                                 # "none": a pad-only block
        keep = np.zeros((n, tq, tk), bool)
    m = np.full((n, h, tq, 1), -np.inf, np.float32)
    den = np.zeros((n, h, tq, 1), np.float32)
    acc = np.zeros((n, h, tq, d), np.float32)
    if carry == "hop":
        k0, v0 = (r.normal(size=(n, h, tk, d)).astype(np.float32)
                  for _ in range(2))
        keep0 = r.random((n, tq, tk)) > 0.5
        keep0[:, :2] = False              # rows 0-1 unseen so far
        m, den, acc = (x.numpy() for x in ta.attention_block_update(
            *map(torch.from_numpy, (q, k0, v0, keep0, m, den, acc)),
            ta.resolve_scale(None, d), impl="torch"))
    return q, k, v, keep, m, den, acc


def _tie_inputs(kind, seed):
    """Integer q and k with ties at the block max: ``duplicated_keys``
    (the second half of the keys repeats the first) or ``m_at_row_max``
    (the carried m set to each row's largest kept score, where the max
    splits dm' half and half)."""
    n, h, tq, tk, d = 2, 2, 16, 24, 16
    q, k, v, keep, m, den, acc = _inputs(n, h, tq, tk, d, "holes", "hop",
                                         seed, integer=True)
    scale = ta.resolve_scale(None, d)
    if kind == "duplicated_keys":
        k[:, :, tk // 2:] = k[:, :, :tk // 2]
    else:
        s = np.einsum("nhqd,nhkd->nhqk", q, k).astype(np.float32) \
            * np.float32(scale)
        s = np.where(keep[:, None], s, -np.inf)
        b = s.max(axis=-1, keepdims=True)
        m = np.where(np.isfinite(b), b, m).astype(np.float32)
    return (q, k, v, keep, m, den, acc), scale


def _cotangents(n, h, tq, d, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, h, tq, 1)).astype(np.float32),
            r.normal(size=(n, h, tq, 1)).astype(np.float32),
            r.normal(size=(n, h, tq, d)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _closed_form(args, grads, scale):
    got = ta.block_update_backward_reference(tuple(_torch(grads)),
                                             *_torch(args), scale)
    return [g.numpy() for g in got]


def _jax_vjp(args, grads, scale):
    jax, jnp, ja = _jax()
    q, k, v, keep, m, den, acc = args

    def fn(q, k, v, m, den, acc):
        return ja.attention_block_update(q, k, v, jnp.asarray(keep), m, den,
                                         acc, np.float32(scale), impl="xla")

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, m, den, acc)))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, grads)))]


def _assert_same(got, want, atol=ATOL):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        # NaN on both sides at the same places (dm of dead rows), finite
        # everywhere else
        assert (np.isfinite(g) == np.isfinite(w)).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("keep_kind,carry,shape", [
    ("holes", "init", (2, 2, 16, 16, 8)),
    ("holes", "hop", (2, 2, 37, 29, 16)),
    ("causal", "init", (1, 2, 24, 24, 16)),
    ("causal", "hop", (1, 2, 24, 24, 16)),
    ("none", "init", (1, 2, 8, 8, 8)),
    ("none", "hop", (2, 2, 16, 16, 8)),
    ("all", "init", (2, 1, 8, 33, 8)),
    ("all", "hop", (2, 1, 8, 33, 8)),
])
def test_closed_form_matches_jax_vjp(keep_kind, carry, shape):
    n, h, tq, tk, d = shape
    args = _inputs(n, h, tq, tk, d, keep_kind, carry, seed=tq + tk)
    grads = _cotangents(n, h, tq, d, seed=tq * tk)
    scale = ta.resolve_scale(None, d)
    got = _closed_form(args, grads, scale)
    _assert_same(got, _jax_vjp(args, grads, scale))
    for g in got[:3]:
        assert np.isfinite(g).all()


@pytest.mark.parametrize("reference", ["autograd", "jax"])
@pytest.mark.parametrize("kind", ["duplicated_keys", "m_at_row_max"])
def test_closed_form_at_ties_matches_autograd_and_jax(kind, reference):
    args, scale = _tie_inputs(kind, seed=11)
    q, k, v, keep, m, den, acc = args
    grads = _cotangents(*q.shape[:3], q.shape[3], seed=12)
    terms = ta._block_backward_terms(tuple(_torch(grads)), *_torch(args),
                                     scale)
    # the case is what it claims: keys tied at the block max, and carried
    # maxima equal to it
    if kind == "duplicated_keys":
        assert int((terms["count"] > 1).sum()) > 10
    else:
        assert int((torch.from_numpy(m) == terms["b"]).sum()) > 10
    if reference == "jax":
        want = _jax_vjp(args, grads, scale)
    else:
        want = [g.numpy() for g in ta.block_update_backward(
            tuple(_torch(grads)), *_torch(args), scale)]
    _assert_same(_closed_form(args, grads, scale), want)


def test_ties_split_the_gradient_as_torch_maximum_and_amax():
    """One row by hand: two kept keys tie at the block max, which equals
    the carried m: dm' goes half to m and half to the keys, a quarter to
    each, as torch.maximum and amax (and jnp.maximum and max) do."""
    q = torch.tensor([[[[1.0, 0.0]]]])
    k = torch.tensor([[[[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]]])
    v = torch.zeros(1, 1, 3, 2)
    keep = torch.ones(1, 1, 3, dtype=torch.bool)
    m = torch.tensor([[[[1.0]]]])
    den, acc = torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 1, 2)
    g_m = torch.ones(1, 1, 1, 1)
    grads = (g_m, torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 1, 2))
    dq, dk, _, dm, _, _ = ta.block_update_backward_reference(
        grads, q, k, v, keep, m, den, acc, 1.0)
    # c = 1, dc = 0, dp = 0: dm' = gm = 1
    assert float(dm) == 0.5
    np.testing.assert_array_equal(dk[0, 0, :, 0].numpy(), [0.25, 0.25, 0.0])
    np.testing.assert_array_equal(dq[0, 0, 0].numpy(), [0.5, 0.0])
    want = ta.block_update_backward(grads, q, k, v, keep, m, den, acc, 1.0)
    for g, w in zip((dq, dk, dm), (want[0], want[1], want[3])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_dead_rows_give_nan_in_dm_and_nowhere_else():
    """A row whose carried m is -inf and which keeps no key of the block:
    NaN in its dm, as autograd of the plain update gives, and finite
    gradients everywhere else."""
    args = _inputs(2, 2, 16, 16, 8, "holes", "init", seed=4)
    grads = _cotangents(2, 2, 16, 8, seed=5)
    got = _closed_form(args, grads, ta.resolve_scale(None, 8))
    dead = ~args[3].any(axis=2)                       # [N, Tq]
    assert dead.any()
    np.testing.assert_array_equal(~np.isfinite(got[3][..., 0]),
                                  np.broadcast_to(dead[:, None],
                                                  got[3].shape[:3]))
    for name, g in zip(NAMES, got):
        if name != "dm":
            assert np.isfinite(g).all(), name
    # such a row takes nothing from the block
    assert (got[0][0, :, 1] == 0).all() and (got[5][0, :, 1] == 0).all()


@pytest.mark.parametrize("case", ["holes_hop", "causal_hop", "all_init",
                                  "duplicated_keys", "m_at_row_max"])
def test_other_evaluations_lie_within_the_error_bound(case):
    """The autograd route (float32, other orders) and the closed form in
    float64 both lie within ``block_update_backward_error_bound`` at
    ``REL`` of the float32 closed form; the integer tie cases with no
    allowance for a tie seen differently (``exact``)."""
    exact = case in ("duplicated_keys", "m_at_row_max")
    if exact:
        args, scale = _tie_inputs(case, seed=21)
    else:
        kind, carry = case.split("_")
        args = _inputs(2, 2, 40, 40, 16, kind, carry, seed=22)
        scale = ta.resolve_scale(None, 16)
    ts = _torch(args)
    grads = tuple(_torch(_cotangents(*args[0].shape[:3], args[0].shape[3],
                                     seed=23)))
    want = ta.block_update_backward_reference(grads, *ts, scale)
    bounds = ta.block_update_backward_error_bound(grads, *ts, scale, REL,
                                                  exact=exact)
    f64 = ta.block_update_backward_reference(
        tuple(g.double() for g in grads),
        *(t.double() if t.dtype == torch.float32 else t for t in ts), scale)
    for other in (ta.block_update_backward(grads, *ts, scale), f64):
        for name, g, w, bnd in zip(NAMES, other, want, bounds):
            fin = torch.isfinite(w)
            assert torch.equal(torch.isfinite(g), fin), name
            diff = (g[fin].double() - w[fin].double()).abs()
            assert bool((diff <= bnd[fin]).all()), (
                name, float((diff / bnd[fin].clamp_min(1e-300)).max()))


def test_error_bound_catches_a_wrong_split_at_a_tie():
    """Passing all of dm' to both sides of a tie, where the max splits it
    half and half, lies far outside the bound."""
    args, scale = _tie_inputs("m_at_row_max", seed=31)
    ts = _torch(args)
    grads = tuple(_torch(_cotangents(*args[0].shape[:3], args[0].shape[3],
                                     seed=32)))
    t = ta._block_backward_terms(grads, *ts, scale)
    want = ta.block_update_backward_reference(grads, *ts, scale)
    bounds = ta.block_update_backward_error_bound(grads, *ts, scale, REL,
                                                  exact=True)
    tie = ts[4] == t["b"]
    wrong = torch.where(tie, t["c"] * t["dc"] + t["dm_new"], want[3])
    fin = torch.isfinite(want[3])
    over = (wrong - want[3]).abs()[fin] / bounds[3][fin]
    assert float(over.max()) > 100


def test_sp_step_through_the_kernel_function_matches_the_plain_route(
        monkeypatch):
    """One SGD step of a tiny causal TransformerTagger on ``sp=4`` virtual
    ranks through the kernel route's ``autograd.Function`` at every hop,
    its forward and backward launches swapped for the plain forward and
    the closed form (the kernels run only on a card), against the same
    step through the plain route: the loss, every gradient and every
    parameter after the step within 1e-5 (``ATOL``, as
    ``tests/test_torch_sequence_parallel.py`` holds the trainers). Row 1
    leaves ranks 1-3 pad only and row 3 is all pad (weight 0), so the
    backward meets dead rows; every gradient stays finite."""
    from mmlspark_tpu_torch.models import sequence as tseq
    from mmlspark_tpu_torch.train import loop as tloop
    kw = dict(vocab_size=61, embed_dim=32, num_heads=4, num_layers=2,
              mlp_dim=64, num_tags=61, max_len=32, causal=True,
              pad_token_id=0)
    r = np.random.default_rng(41)
    x = r.integers(1, 61, size=(4, 32)).astype(np.int64)
    y = r.integers(1, 61, size=(4, 32)).astype(np.int64)
    x[0, 20:] = y[0, 20:] = 0
    x[1, 8:] = y[1, 8:] = 0
    x[3] = y[3] = 0
    w = np.array([1, 1, 1, 0], np.float32)
    batch = [torch.from_numpy(a) for a in (x, y, w)]

    def step():
        model = tseq.TransformerTagger(device="cpu", **kw)
        tseq.init_sequence_(model, torch.Generator().manual_seed(0))
        trainer = tloop.Trainer(model, tloop.TrainConfig(
            mesh_spec={"sp": 4}, device="cpu", batch_size=4,
            learning_rate=0.1, optimizer="sgd"))
        loss = trainer.train_step(*batch)
        return (float(loss),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: v.clone() for n, v in model.state_dict().items()})

    plain = step()
    calls = {"forward": 0, "backward": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(ta, "resolve_impl", lambda impl, q: "cuda")
    monkeypatch.setattr(ta, "_block_update_cuda",
                        counted("forward", ta.block_update_reference))
    monkeypatch.setattr(ta, "_block_update_bwd_cuda",
                        counted("backward",
                                ta.block_update_backward_reference))
    launches = ta.block_update_backward_launches
    kernel = step()
    hops = 4 * kw["num_layers"]
    assert calls == {"forward": hops, "backward": hops}
    assert ta.block_update_backward_launches == launches
    np.testing.assert_allclose(kernel[0], plain[0], rtol=0, atol=ATOL)
    for got, want in zip(kernel[1:], plain[1:]):
        assert set(got) == set(want)
        for name in want:
            assert torch.isfinite(got[name]).all(), name
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=ATOL, err_msg=name)


def test_backward_wrapper_takes_cuda_tensors_only():
    args = _torch(_inputs(1, 1, 8, 8, 8, "all", "hop", seed=51))
    grads = tuple(_torch(_cotangents(1, 1, 8, 8, seed=52)))
    before = (ta.block_update_backward_launches,
              ta.block_update_backward_copies)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta._block_update_bwd_cuda(grads, *args, 0.35)
    assert (ta.block_update_backward_launches,
            ta.block_update_backward_copies) == before


def test_kernel_entry_takes_the_arguments_the_wrapper_passes():
    """The C signature of ``block_update_bwd`` against the ctypes types
    the wrapper sets: the same count and kind of every argument (a
    mismatch would show only on the card)."""
    src = os.path.join(os.path.dirname(ta.__file__), "csrc",
                       "block_update_bwd.cu")
    with open(src) as f:
        text = f.read()
    sig = re.search(r"int block_update_bwd\(([^)]*)\)", text).group(1)
    kinds = []
    for param in (p.strip() for p in sig.split(",")):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(param)
    assert kinds == ta._BLOCK_BWD_ARGTYPES


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_closed_form():
    """The backward kernel against its plain version (the closed form) on
    the card, at the ring's geometry and the edge cases (pad-only blocks
    on a hop carry and on the initial carry, causal, holes, D in {32,
    128}, a ragged 37 × 200, duplicated keys and m at the row max), each
    launched twice (equal bit for bit), within
    ``block_update_backward_error_bound`` at ``REL``, the integer tie
    cases with no allowance for a tie seen differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(_inputs(32, 12, 256, 256, 64, "holes", "hop", 1), False),
             (_inputs(4, 2, 128, 128, 32, "causal", "hop", 2), False),
             (_inputs(2, 3, 128, 128, 128, "holes", "init", 3), False),
             (_inputs(4, 3, 37, 200, 64, "holes", "hop", 4), False),
             (_inputs(2, 2, 64, 64, 16, "none", "hop", 5), False),
             (_inputs(2, 2, 64, 64, 16, "none", "init", 6), False),
             (_tie_inputs("duplicated_keys", 7)[0], True),
             (_tie_inputs("m_at_row_max", 8)[0], True)]
    for seed, (args, exact) in enumerate(cases):
        ts = [t.to(dev) for t in _torch(args)]
        n, h, tq, d = ts[0].shape
        scale = ta.resolve_scale(None, d)
        grads = tuple(t.to(dev) for t in _torch(_cotangents(n, h, tq, d,
                                                            seed)))
        before = ta.block_update_backward_launches
        got = ta._block_update_bwd_cuda(grads, *ts, scale)
        again = ta._block_update_bwd_cuda(grads, *ts, scale)
        torch.cuda.synchronize()
        assert ta.block_update_backward_launches == before + 2
        want = ta.block_update_backward_reference(grads, *ts, scale)
        bounds = ta.block_update_backward_error_bound(grads, *ts, scale,
                                                      REL, exact=exact)
        for name, g, a, w, bnd in zip(NAMES, got, again, want, bounds):
            assert torch.equal(g.view(torch.int32), a.view(torch.int32)), \
                name
            fin = torch.isfinite(w)
            assert torch.equal(torch.isfinite(g), fin), name
            diff = (g[fin].double() - w[fin].double()).abs()
            assert bool((diff <= bnd[fin]).all()), (
                name, tuple(args[0].shape),
                float((diff / bnd[fin].clamp_min(1e-300)).max()))


# The backward kernel's arithmetic: every product in 3xTF32 (each float32
# operand split into a TF32 high part and the TF32 rounding of the rest,
# lo.hi + hi.lo + hi.hi summed in float32), emulated here in plain PyTorch
# and held to the same bound as the kernel on the card.
_SCHEME_CASES = [
    ("holes", "init", (2, 2, 16, 16, 8)),
    ("holes", "hop", (2, 2, 37, 29, 16)),
    ("causal", "init", (1, 2, 24, 24, 16)),
    ("causal", "hop", (1, 2, 24, 24, 16)),
    ("none", "init", (1, 2, 8, 8, 8)),
    ("none", "hop", (2, 2, 16, 16, 8)),
    ("all", "init", (2, 1, 8, 33, 8)),
    ("all", "hop", (2, 1, 8, 33, 8)),
    ("duplicated_keys", None, None),
    ("m_at_row_max", None, None),
]


def _tf32(x):
    """``x`` rounded to TF32 (10 stored significand bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 bits,
    add half of the 13 dropped bits' unit to the magnitude and clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def _matmul_1xtf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _scheme_inputs(case):
    kind, carry, shape = case
    if carry is None:
        args, scale = _tie_inputs(kind, seed=61)
        shape = args[0].shape
    else:
        n, h, tq, tk, d = shape
        args = _inputs(n, h, tq, tk, d, kind, carry, seed=tq + tk + 60)
        scale = ta.resolve_scale(None, d)
    q = args[0]
    grads = tuple(_torch(_cotangents(*q.shape[:3], q.shape[3], seed=62)))
    return _torch(args), grads, scale, carry is None


def _over_bound(matmul, case):
    """The closed form with ``matmul`` for its five products against the
    float32 closed form: the largest ratio of each gradient's difference
    to ``block_update_backward_error_bound`` at ``REL`` (the integer tie
    cases with no allowance for a tie seen differently), after checking
    that both are finite at the same places."""
    ts, grads, scale, exact = _scheme_inputs(case)
    want = ta.block_update_backward_reference(grads, *ts, scale)
    got = ta.block_update_backward_reference(grads, *ts, scale,
                                             matmul=matmul)
    bounds = ta.block_update_backward_error_bound(grads, *ts, scale, REL,
                                                  exact=exact)
    ratios = {}
    for name, g, w, bnd in zip(NAMES, got, want, bounds):
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin), name
        diff = (g[fin].double() - w[fin].double()).abs()
        ratios[name] = float((diff / bnd[fin].clamp_min(1e-300)).max()) \
            if diff.numel() else 0.0
    return ratios


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` keeps 10 stored significand bits, rounds to nearest and
    breaks a tie away from zero, for either sign; small integers are
    exact, so the kernel's integer scores stay exact."""
    one = 1.0
    ulp = 2.0 ** -10                  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, -(one + ulp / 2), 3.0, -17.0,
                      0.0, 2.0 ** -20 * 3], dtype=torch.float32)
    want = [one + ulp, one, one + 2 * ulp, -(one + ulp), 3.0, -17.0, 0.0,
            2.0 ** -20 * 3]
    assert _tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(63).normal(size=4096)
                         .astype(np.float32))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    rel = ((y.double() - hi.double() - lo.double()).abs()
           / y.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("case", _SCHEME_CASES,
                         ids=["-".join(map(str, c[:2])) for c in
                              _SCHEME_CASES])
def test_3xtf32_closed_form_lies_within_the_error_bound(case):
    """The closed form with its five products (s, dp, dq, dk, dv) in
    3xTF32 lies within ``block_update_backward_error_bound`` at ``REL``
    of the float32 closed form on the file's cases: keep holes, causal,
    pad only and every key, on the initial and a hop carry; the two
    integer tie cases with ``exact=True`` (their scores are exact in the
    TF32 high part, so the ties are the same)."""
    ratios = _over_bound(_matmul_3xtf32, case)
    assert max(ratios.values()) <= 1, ratios


@pytest.mark.parametrize("case", [c for c in _SCHEME_CASES
                                  if c[0] != "none"],
                         ids=["-".join(map(str, c[:2])) for c in
                              _SCHEME_CASES if c[0] != "none"])
def test_1xtf32_closed_form_falls_outside_the_error_bound(case):
    """One TF32 product per float32 product (about 2^-11 of each term)
    lies outside the bound on every case that keeps a key: the bound
    catches a scheme that is too coarse for float32 gradients."""
    ratios = _over_bound(_matmul_1xtf32, case)
    assert max(ratios.values()) > 1, ratios
