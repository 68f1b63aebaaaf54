"""The ring-hop block update (mmlspark_tpu_torch/ops/attention.py
``attention_block_update``) against the JAX package's, on numpy-seeded
inputs.

The plain version is held against JAX ``attention_block_update`` with
``impl="xla"`` (the shared ``_online_update`` vmapped) and with
``impl="pallas"`` (the Pallas kernel ``_update_call``, in interpret mode on
the CPU, as tests/test_attention.py runs it), for carries that start at
``(-inf, 0, 0)`` and carries taken from a previous block, and its gradient
against ``jax.grad`` of the ``xla`` route.

Tolerance 1e-5 absolute on ``m``, ``denom``, ``acc`` and ``acc / denom``:
both sides compute in float32 from the same operands and differ only in
the summation order of the two matrix products (XLA's against PyTorch's),
a few 1e-7 on values of order 1 at these sizes. The gradients carry the
same rounding through one more product: 1e-5 as well.

The CUDA kernel runs only on a card: its test is marked ``cuda`` and skips
here (``chip_smoke.py`` holds the kernel against the plain version at the
ring's geometry).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import attention as ta

ATOL = 1e-5


def _jax():
    """jax, jax.numpy and the JAX package's attention module, imported
    only by the tests that compare with them (the card's machine has no
    JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from mmlspark_tpu.ops.pallas import attention as ja
    return jax, jnp, ja


def _inputs(n, h, tq, tk, d, keep_kind, carry, seed):
    """numpy q, k, v, keep and a carry. ``carry``: "init" (the ring's
    start, -inf/0/0) or "hop" (the output of one update over another
    block, with some rows still unseen)."""
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(n, h, t, d)).astype(np.float32)
               for t in (tq, tk, tk))
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


def _port(q, k, v, keep, m, den, acc, scale, impl="auto"):
    out = ta.attention_block_update(
        *(torch.from_numpy(np.array(a))
          for a in (q, k, v, keep, m, den, acc)), scale, impl=impl)
    return [o.numpy() for o in out]


def _jax_update(q, k, v, keep, m, den, acc, scale, impl):
    jax, jnp, ja = _jax()
    fn = jax.jit(lambda *a: ja.attention_block_update(*a, scale, impl=impl))
    return [np.asarray(o) for o in fn(*map(jnp.asarray,
                                            (q, k, v, keep, m, den, acc)))]


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    out_g = got[2] / np.maximum(got[1], 1e-30)
    out_w = want[2] / np.maximum(want[1], 1e-30)
    np.testing.assert_allclose(out_g, out_w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("keep_kind,carry,shape", [
    ("holes", "init", (2, 2, 16, 16, 8)),
    ("holes", "hop", (2, 2, 16, 16, 8)),
    ("causal", "hop", (1, 3, 24, 24, 16)),
    ("all", "hop", (2, 1, 8, 40, 8)),
    ("none", "hop", (2, 2, 16, 16, 8)),
    ("none", "init", (1, 2, 8, 8, 8)),
])
def test_plain_update_matches_jax(jax_impl, keep_kind, carry, shape):
    n, h, tq, tk, d = shape
    args = _inputs(n, h, tq, tk, d, keep_kind, carry, seed=tq + tk)
    scale = ta.resolve_scale(None, d)
    got = _port(*args, scale)
    want = _jax_update(*args, np.float32(scale), jax_impl)
    _assert_close(got, want)


def test_a_pad_only_block_leaves_the_carry_as_it_was():
    q, k, v, keep, m, den, acc = _inputs(2, 2, 16, 16, 8, "none", "hop", 3)
    got_m, got_d, got_a = _port(q, k, v, keep, m, den, acc, 0.35)
    np.testing.assert_array_equal(got_m, m)
    np.testing.assert_array_equal(got_d, den)
    np.testing.assert_array_equal(got_a, acc)
    q, k, v, keep, m, den, acc = _inputs(2, 2, 16, 16, 8, "none", "init", 3)
    got_m, got_d, got_a = _port(q, k, v, keep, m, den, acc, 0.35)
    assert np.isneginf(got_m).all()
    assert (got_d == 0).all() and (got_a == 0).all()


def _loss_weights(n, h, tq, d, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, h, tq, d)).astype(np.float32),
            r.normal(size=(n, h, tq, 1)).astype(np.float32),
            r.normal(size=(n, h, tq, 1)).astype(np.float32))


@pytest.mark.parametrize("carry", ["init", "hop"])
def test_plain_gradient_matches_jax_grad(carry):
    n, h, tq, tk, d = 2, 2, 16, 16, 8
    q, k, v, keep, m, den, acc = _inputs(n, h, tq, tk, d, "holes", carry, 5)
    wa, wd, wm = _loss_weights(n, h, tq, d, 6)
    jax, jnp, ja = _jax()
    scale = np.float32(ta.resolve_scale(None, d))

    # a weighted sum of the three outputs (m where it is finite)
    def jloss(q, k, v, m, den, acc):
        m2, d2, a2 = ja.attention_block_update(
            q, k, v, jnp.asarray(keep), m, den, acc, scale, impl="xla")
        return (jnp.sum(a2 * wa) + jnp.sum(d2 * wd)
                + jnp.sum(jnp.where(jnp.isfinite(m2), m2, 0.0) * wm))

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (q, k, v, m, den, acc)))
    ts = [torch.from_numpy(a).requires_grad_() for a in
          (q, k, v, m, den, acc)]
    tq_, tk_, tv_, tm_, td_, ta_ = ts
    m2, d2, a2 = ta.attention_block_update(
        tq_, tk_, tv_, torch.from_numpy(keep), tm_, td_, ta_, float(scale))
    ((a2 * torch.from_numpy(wa)).sum() + (d2 * torch.from_numpy(wd)).sum()
     + (torch.where(torch.isfinite(m2), m2, 0.0)
        * torch.from_numpy(wm)).sum()).backward()
    for name, t, w in zip("q k v m denom acc".split(), ts, want):
        w = np.asarray(w)
        g = t.grad.numpy()
        # the gradient of a carried m that is -inf where the block keeps
        # no key either: NaN on both sides (exp(-inf - -inf) in the branch
        # not taken, times 0), and nowhere else
        assert (np.isfinite(g) == np.isfinite(w)).all(), name
        if name == "m":
            assert np.isfinite(g[np.isfinite(m)]).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    for t in ts[:3]:
        assert torch.isfinite(t.grad).all()


def test_one_update_over_the_whole_block_is_attention():
    """A single update from the initial carry, then the division, is the
    flash attention of the block."""
    q, k, v, keep, m, den, acc = _inputs(2, 3, 24, 24, 8, "causal", "init",
                                         9)
    scale = ta.resolve_scale(None, 8)
    _, got_d, got_a = _port(q, k, v, keep, m, den, acc, scale)
    want = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(got_a / np.maximum(got_d, 1e-30), want,
                               rtol=0, atol=ATOL)


def _small(d=8, dtype=torch.float32):
    q = torch.zeros(2, 2, 4, d, dtype=dtype)
    kv = torch.zeros(2, 2, 6, d, dtype=dtype)
    keep = torch.ones(2, 4, 6, dtype=torch.bool)
    m = torch.full((2, 2, 4, 1), float("-inf"), dtype=dtype)
    den = torch.zeros(2, 2, 4, 1, dtype=dtype)
    acc = torch.zeros(2, 2, 4, d, dtype=dtype)
    return q, kv, kv, keep, m, den, acc


@pytest.mark.parametrize("impl", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("d", [4, 12, 136])
def test_unsupported_head_width_raises(d, impl):
    with pytest.raises(ValueError, match="head width"):
        ta.attention_block_update(*_small(d), 0.5, impl=impl)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_non_float32_operands_raise(dtype):
    with pytest.raises(TypeError, match="float32"):
        ta.attention_block_update(*_small(dtype=dtype), 0.5)


def test_shape_mismatch_raises():
    q, k, v, keep, m, den, acc = _small()
    with pytest.raises(ValueError, match="keep3"):
        ta.attention_block_update(q, k, v, keep[:, :3], m, den, acc, 0.5)
    with pytest.raises(ValueError, match="acc"):
        ta.attention_block_update(q, k, v, keep, m, den, acc[..., :4], 0.5)
    with pytest.raises(ValueError, match="v4"):
        ta.attention_block_update(q, k, v[:, :, :5], keep, m, den, acc, 0.5)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.attention_block_update(*_small(), 0.5, impl="pallas")


def test_cuda_impl_on_cpu_tensors_raises_and_launches_nothing():
    before = ta.block_update_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.attention_block_update(*_small(), 0.5, impl="cuda")
    ta.attention_block_update(*_small(), 0.5)  # the plain version
    assert ta.block_update_launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at the
    ring's geometry (N = sp·B = 32, H=12, 256 × 256, D=64) and the edge
    cases, with the gradient of its backward. Tolerance 1e-5 on m and on
    acc/denom: both run in float32 from the same operands; the kernel
    merges 64-key stripes one after another where the plain version
    takes the whole block at once, which moves the result by rounding
    only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for shape, keep_kind, carry in [((32, 12, 256, 256, 64), "holes", "hop"),
                                    ((4, 2, 37, 200, 32), "holes", "hop"),
                                    ((2, 3, 128, 128, 128), "causal", "init"),
                                    ((2, 2, 64, 64, 16), "none", "hop"),
                                    ((2, 2, 64, 64, 16), "none", "init")]:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in _inputs(*shape, keep_kind, carry, seed=1)]
        scale = ta.resolve_scale(None, shape[-1])
        before = ta.block_update_launches
        got = ta.attention_block_update(*args, scale)
        torch.cuda.synchronize()
        assert ta.block_update_launches == before + 1
        want = ta.attention_block_update(*args, scale, impl="torch")
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=ATOL)
        torch.testing.assert_close(
            got[2] / torch.clamp(got[1], min=1e-30),
            want[2] / torch.clamp(want[1], min=1e-30), rtol=0, atol=ATOL)
        if keep_kind == "none":
            for g, a in zip(got, (args[4], args[5], args[6])):
                assert torch.equal(g, a)
    q, k, v, keep, m, den, acc = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in _inputs(2, 2, 64, 64, 16, "holes", "hop", seed=2))
    grads = []
    for impl in ("cuda", "torch"):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        _, d2, a2 = ta.attention_block_update(ts[0], ts[1], ts[2], keep, m,
                                              den, acc, 0.25, impl=impl)
        (a2 / torch.clamp(d2, min=1e-30)).sum().backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


# The kernel's arithmetic: both products (the scores and p·v) in 3xTF32
# (each float32 operand split into a TF32 high part and the TF32 rounding
# of the rest, lo.hi + hi.lo + hi.hi summed in float32), emulated here in
# plain PyTorch through the plain version's ``matmul`` keyword. The helpers
# are the backward's (tests/ is on sys.path: it has no __init__.py).
from test_torch_block_update_backward import (  # noqa: E402
    _matmul_1xtf32, _matmul_3xtf32,
)

# the kernel against its plain version on the card (chip_smoke.py)
BLOCK_TOL = 1e-5


def _ring_hop_inputs(seed, b=2, length=256, h=2, d=32, sp=4):
    """The inputs the block update gets at every hop of one causal ring
    over ``sp`` ranks: numpy-seeded random normal q, k, v ``[B, L, H, D]``,
    each row's real length drawn in [L/2, L] and the rest pad, through
    the port's ``ring_attention`` (plain update), each hop's ``(q, k, v,
    keep, m, denom, acc)`` recorded with the carry of the real previous
    hop, as numpy arrays."""
    from mmlspark_tpu_torch.parallel import ring_attention as ring
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.normal(size=(b, length, h, d))
                                .astype(np.float32)) for _ in range(3))
    lengths = r.integers(length // 2, length + 1, b)
    kv_mask = torch.from_numpy(np.arange(length)[None] < lengths[:, None])
    hops = []
    inner = ring.attention_block_update

    def record(*args, impl="auto"):
        hops.append([a.numpy().copy() for a in args[:7]])
        return inner(*args, impl="torch")

    ring.attention_block_update = record
    try:
        ring.ring_attention(q, k, v, make_mesh({"sp": sp}, "cpu"),
                            causal=True, kv_mask=kv_mask)
    finally:
        ring.attention_block_update = inner
    assert len(hops) == sp
    return hops


def _update_err(got, want):
    """The check chip_smoke.py applies to the kernel: the largest gap in
    m (where finite, the -inf rows the same) and in acc / denom."""
    gm, wm = got[0], want[0]
    assert (np.isneginf(gm) == np.isneginf(wm)).all()
    fin = np.isfinite(wm)
    err_m = float(np.abs(gm[fin] - wm[fin]).max()) if fin.any() else 0.0
    out_g = got[2] / np.maximum(got[1], 1e-30)
    out_w = want[2] / np.maximum(want[1], 1e-30)
    return max(err_m, float(np.abs(out_g - out_w).max()))


def test_3xtf32_update_lies_within_block_tol_of_jax_on_ring_hops():
    """The plain update with both products in 3xTF32 lies within
    ``BLOCK_TOL`` of JAX ``attention_block_update(impl="xla")`` at every
    hop of a causal ring (sp=4, pad mask, 256 positions, H=2, D=32), and
    with one TF32 product each at least 10 times farther away (and past
    ``BLOCK_TOL``): the split is required and it is enough. Measured on the
    CPU, by hop: 3xTF32 1.2e-6, 1.4e-6, 1.7e-6, 1.4e-6 (the float32 plain
    version 3.6e-7, 4.8e-7, 2.4e-7, 1.3e-7), a margin of about 6 to
    ``BLOCK_TOL``; one TF32 product 1.3e-3, 1.3e-3, 1.4e-3, 1.0e-3, about
    830 times the 3xTF32 worst."""
    worst3 = worst1 = 0.0
    for hop in _ring_hop_inputs(seed=71):
        scale = ta.resolve_scale(None, hop[0].shape[-1])
        want = _jax_update(*hop, np.float32(scale), "xla")
        args = [torch.from_numpy(a) for a in hop]
        err3, err1 = (_update_err(
            [o.numpy() for o in ta.block_update_reference(
                *args, scale, matmul=mm)], want)
            for mm in (_matmul_3xtf32, _matmul_1xtf32))
        assert err3 <= BLOCK_TOL, err3
        worst3, worst1 = max(worst3, err3), max(worst1, err1)
    assert worst1 > BLOCK_TOL and worst1 >= 10 * worst3, (worst1, worst3)


def test_3xtf32_update_keeps_integer_scores_exact():
    """Small integers are exact in the TF32 high part (the low part is 0),
    so with integer-valued q and k every score, and so m, of the update
    with 3xTF32 products equals the float32 plain version's bit for bit."""
    q, k, v, keep, m, den, acc = _inputs(2, 3, 40, 72, 16, "holes", "hop",
                                         seed=73)
    r = np.random.default_rng(74)
    q, k = (r.integers(-2, 3, size=a.shape).astype(np.float32)
            for a in (q, k))
    args = [torch.from_numpy(a) for a in (q, k, v, keep, m, den, acc)]
    scale = ta.resolve_scale(None, 16)
    got = ta.block_update_reference(*args, scale, matmul=_matmul_3xtf32)
    want = ta.block_update_reference(*args, scale)
    assert torch.isfinite(want[0]).any()
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[2] / torch.clamp(got[1], min=1e-30),
                               want[2] / torch.clamp(want[1], min=1e-30),
                               rtol=0, atol=BLOCK_TOL)


@pytest.mark.cuda
def test_cuda_kernel_keeps_integer_m_exact_and_repeats_bit_for_bit():
    """The tensor-core kernel on integer-valued q and k: m equal to the
    plain version's bit for bit (integers are exact in the TF32 high part),
    acc / denom within ``BLOCK_TOL``, two launches equal bit for bit, also
    with q, k and v off 16 bytes (4-byte staging) and a mask row of 77
    bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    r = np.random.default_rng(75)
    for shape, misalign in (((8, 12, 256, 256, 64), False),
                            ((2, 3, 70, 77, 64), True)):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in _inputs(*shape, "holes", "hop", seed=76)]
        for i in range(2):
            args[i] = torch.from_numpy(r.integers(
                -2, 3, size=tuple(args[i].shape)).astype(np.float32)).to(dev)
        if misalign:
            for i in range(3):
                off = torch.empty(args[i].numel() + 1, device=dev)[1:]
                args[i] = off.view(args[i].shape).copy_(args[i])
        scale = ta.resolve_scale(None, shape[-1])
        got = ta._block_update_cuda(*args, scale)
        again = ta._block_update_cuda(*args, scale)
        want = ta.attention_block_update(*args, scale, impl="torch")
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(
            got[2] / torch.clamp(got[1], min=1e-30),
            want[2] / torch.clamp(want[1], min=1e-30), rtol=0,
            atol=BLOCK_TOL)
