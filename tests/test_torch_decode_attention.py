"""The port's decode attention (``decode_attention`` in
mmlspark_tpu_torch/ops/attention.py).

On the CPU the port's ``decode_attention`` takes its plain PyTorch version;
it is held against the JAX package's three implementations of the same
function on numpy-seeded inputs: the XLA reference
(``decode_attention_reference``), the numpy oracle
(``decode_attention_host``) and the Pallas kernel (``impl="pallas"``, in
interpret mode on the CPU, as ``tests/test_attention.py`` runs it).

Tolerance 2e-6 absolute: every implementation runs the same online-softmax
recurrence over key blocks in float32; they differ only in the order of
the sums over D and over a block's keys.

The CUDA kernel itself runs only on a card: its test is marked ``cuda``
and skips here.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import attention as ta

ATOL = 2e-6
S, H, TK, D = 4, 2, 37, 16
# per-slot valid lengths: an empty slot, one key, mid-block, every key
LENGTHS = (0, 1, 17, 37)


def _inputs(mask_kind: str, seed: int = 0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(S, H, D)).astype(np.float32)
    k = r.normal(size=(S, H, TK, D)).astype(np.float32)
    v = r.normal(size=(S, H, TK, D)).astype(np.float32)
    if mask_kind == "prefix":
        mask = np.arange(TK)[None, :] < np.asarray(LENGTHS)[:, None]
    else:  # not a prefix: holes anywhere, slot 0 still empty
        mask = r.random((S, TK)) < 0.4
        mask[0] = False
        mask[1, 30] = True
    return q, k, v, mask


def _port(q, k, v, mask, scale, block_k):
    return ta.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_mask=torch.from_numpy(mask), scale=scale,
        block_k=block_k).numpy()


def _jax(impl, q, k, v, mask, scale, block_k):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mmlspark_tpu.ops.pallas import attention as fa
    sc = fa._resolve_scale(scale, D)
    if impl == "host":
        return fa.decode_attention_host(
            q, k, v, fa.host_decode_mask2(S, TK, mask), sc, block_k=block_k)
    if impl == "reference":
        return np.asarray(fa.decode_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            fa.decode_mask2(S, TK, jnp.asarray(mask)), sc, block_k=block_k))
    return np.asarray(fa.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask), scale=scale, impl="pallas",
        block_k=block_k))


@pytest.mark.parametrize("block_k", [16, 128])
@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("mask_kind", ["prefix", "holes"])
@pytest.mark.parametrize("jax_impl", ["reference", "host", "pallas"])
def test_matches_jax_decode_attention(jax_impl, mask_kind, scale, block_k):
    inputs = _inputs(mask_kind)
    got = _port(*inputs, scale, block_k)
    want = _jax(jax_impl, *inputs, scale, block_k)
    assert got.dtype == np.float32 and got.shape == (S, H, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the empty slot: exact zeros on both sides
    assert (got[0] == 0.0).all() and (np.asarray(want)[0] == 0.0).all()
    assert np.isfinite(got).all() and (got[1:] != 0.0).any()


def test_reference_is_the_plain_softmax():
    """The online recurrence is algebra: it equals one masked softmax."""
    q, k, v, mask = _inputs("prefix", seed=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scores = (tq[:, :, None, :] * tk).sum(-1) * ta.resolve_scale(None, D)
    keep = torch.from_numpy(mask)[:, None, :]
    w = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    want = (w[..., None] * tv).sum(-2)
    got = ta.decode_attention(tq, tk, tv, kv_mask=keep[:, 0], block_k=16)
    np.testing.assert_allclose(got[1:].numpy(), want[1:].numpy(), rtol=0,
                               atol=ATOL)


def test_no_mask_attends_to_every_key():
    q, k, v, _ = _inputs("prefix", seed=5)
    full = np.ones((S, TK), bool)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_array_equal(
        ta.decode_attention(*args).numpy(),
        ta.decode_attention(*args, kv_mask=torch.from_numpy(full)).numpy())


def test_int8_mask_is_taken_as_is():
    """An int8 mask (what the model converts once per decode step) gives
    the bool mask's result; any nonzero byte attends."""
    q, k, v, mask = _inputs("holes", seed=6)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    as_bool = ta.decode_attention(*args, kv_mask=torch.from_numpy(mask))
    as_int8 = ta.decode_attention(
        *args, kv_mask=torch.from_numpy(mask.astype(np.int8) * 3))
    np.testing.assert_array_equal(as_int8.numpy(), as_bool.numpy())


def _small(d=16, dtype=torch.float32):
    return (torch.zeros(2, 2, d, dtype=dtype),
            torch.zeros(2, 2, 8, d, dtype=dtype),
            torch.zeros(2, 2, 8, d, dtype=dtype))


@pytest.mark.parametrize("impl", ["pallas", "xla", "triton", ""])
def test_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.decode_attention(*_small(), impl=impl)


@pytest.mark.parametrize("d", [12, 136])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_unsupported_head_width_raises(d, impl):
    with pytest.raises(ValueError, match="head width"):
        ta.decode_attention(*_small(d=d), impl=impl)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_non_float32_cache_raises(dtype):
    with pytest.raises(TypeError, match="float32"):
        ta.decode_attention(*_small(dtype=dtype))


def test_shape_mismatch_and_bad_mask_raise():
    q, k, v = _small()
    with pytest.raises(ValueError, match="shape mismatch"):
        ta.decode_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError, match=r"\[S, Tk\]"):
        ta.decode_attention(q, k, v, kv_mask=torch.ones(2, 7, dtype=bool))


def test_cuda_impl_on_cpu_tensors_raises_and_launches_nothing():
    before = ta.decode_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.decode_attention(*_small(), impl="cuda")
    ta.decode_attention(*_small())  # the plain version on CPU tensors
    assert ta.decode_launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at the
    generation path's shape (a strided layer slice of the cache, a strided
    q view) and the edge cases. Tolerance 1e-5: both run in float32 from
    the same operands and differ in summation order and in ``expf``
    against ``torch.exp``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for s, h, tk, d, lens in [(32, 12, 1024, 64, None),
                              (4, 2, 37, 16, (0, 1, 17, 37)),
                              (3, 4, 300, 128, (300, 0, 33)),
                              (2, 3, 65, 40, (65, 64))]:
        cache = torch.randn(s, 2, h, tk, d, generator=gen, device=dev)
        k, v = cache[:, 0], cache[:, 1]
        qkv = torch.randn(s, 3 * h * d, generator=gen, device=dev)
        q = qkv[:, :h * d].reshape(s, h, d)
        kv = None if lens is None else (
            torch.arange(tk, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
        before = ta.decode_launches
        got = ta.decode_attention(q, k, v, kv_mask=kv)
        torch.cuda.synchronize()
        assert ta.decode_launches == before + 1
        want = ta.decode_attention(q, k, v, kv_mask=kv, impl="torch")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        if lens is not None and 0 in lens:
            assert (got[lens.index(0)] == 0).all()
