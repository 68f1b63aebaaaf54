"""The port's flash attention (mmlspark_tpu_torch/ops/attention.py).

On the CPU the port's ``flash_attention`` takes its plain PyTorch version;
it is held against the JAX package's three implementations of the same
function on numpy-seeded inputs: the XLA reference (``impl="xla"``), the
numpy oracle (``flash_attention_host``) and the Pallas kernel
(``impl="pallas"``, in interpret mode on the CPU, as
``tests/test_attention.py`` runs it).

Tolerance ``rtol=2e-5, atol=2e-6`` (the JAX package's own pin of its
kernel against a plain softmax): every implementation upcasts to float32
and runs the same block recurrence; they differ only in the summation
order of the two products. bfloat16 inputs are rounded identically on
both sides and upcast exactly, so they take the same tolerance.

The CUDA kernel itself runs only on a card: its test is marked ``cuda``
and skips here.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import attention as ta

TOL = dict(rtol=2e-5, atol=2e-6)

# name → (B, H, Tq, Tk, D, kv lengths or None, causal, block_k, dtype)
CASES = {
    "plain": (2, 3, 48, 48, 16, None, False, 128, "f32"),
    "kv_mask_fully_masked_row": (2, 3, 48, 48, 16, (48, 0), False, 16,
                                 "f32"),
    "causal": (2, 3, 48, 48, 16, (48, 37), True, 16, "f32"),
    "ragged_tk": (2, 2, 40, 37, 16, (37, 21), False, 16, "f32"),
    "bf16": (2, 3, 48, 48, 32, (48, 30), False, 16, "bf16"),
}


def _inputs(case, seed=0):
    b, h, tq, tk, d, lens, causal, block_k, dtype = CASES[case]
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, tq, d)).astype(np.float32)
    k = r.normal(size=(b, h, tk, d)).astype(np.float32)
    v = r.normal(size=(b, h, tk, d)).astype(np.float32)
    mask = None if lens is None else \
        np.arange(tk)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, mask, causal, block_k, dtype


def _port(q, k, v, mask, causal, block_k, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    kv = None if mask is None else torch.from_numpy(mask)
    return ta.flash_attention(*args, kv_mask=kv, causal=causal,
                              block_k=block_k).numpy()


def _jax_fa():
    pytest.importorskip("jax")
    from mmlspark_tpu.ops.pallas import attention as fa
    return fa


def _jax(impl, q, k, v, mask, causal, block_k, dtype):
    import jax.numpy as jnp
    fa = _jax_fa()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    if impl == "host":
        b, _, tq, d = q.shape
        m3 = fa.host_mask3(b, tq, k.shape[2], mask, causal)
        return fa.flash_attention_host(
            np.asarray(jq, np.float32), np.asarray(jk, np.float32),
            np.asarray(jv, np.float32), m3, fa._resolve_scale(None, d),
            block_k=block_k)
    kv = None if mask is None else jnp.asarray(mask)
    return np.asarray(fa.flash_attention(jq, jk, jv, kv_mask=kv,
                                         causal=causal, impl=impl,
                                         block_k=block_k))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_impl", ["xla", "host", "pallas"])
def test_matches_jax_flash_attention(jax_impl, case):
    inputs = _inputs(case)
    got = _port(*inputs)
    want = _jax(jax_impl, *inputs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_fully_masked_rows_are_exact_zeros():
    q, k, v, mask, causal, block_k, dtype = _inputs(
        "kv_mask_fully_masked_row", seed=3)
    out = _port(q, k, v, mask, causal, block_k, dtype)
    assert (out[1] == 0.0).all()
    assert np.isfinite(out).all() and (out[0] != 0.0).any()


def test_reference_is_the_plain_softmax():
    """The online recurrence is algebra: it equals one full softmax."""
    q, k, v, _, _, _, _ = _inputs("plain", seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scores = tq @ tk.transpose(-1, -2) * ta.resolve_scale(None, q.shape[-1])
    want = torch.softmax(scores, dim=-1) @ tv
    got = ta.flash_attention(tq, tk, tv, block_k=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _small(d=16, dtype=torch.float32):
    return [torch.zeros(1, 2, 8, d, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("impl", ["pallas", "xla", "triton", ""])
def test_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.flash_attention(*_small(), impl=impl)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_unsupported_dtype_raises(dtype):
    with pytest.raises(TypeError, match="dtype"):
        ta.flash_attention(*_small(dtype=dtype))


@pytest.mark.parametrize("d", [12, 4, 136, 256])
def test_unsupported_head_width_raises(d):
    with pytest.raises(ValueError, match="head width"):
        ta.flash_attention(*_small(d=d))


def test_cuda_impl_on_cpu_tensors_raises_and_launches_nothing():
    before = ta.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.flash_attention(*_small(), impl="cuda")
    ta.flash_attention(*_small())  # the plain version on CPU tensors
    assert ta.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at the
    ViT-B/16 attention shape and the edge cases. Tolerance 1e-4: both
    accumulate in float32 from the same float32 operands, and differ in
    summation order and in ``expf`` against ``torch.exp``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(8, 12, 196, 196, 64, torch.bfloat16, None, False),
              (2, 12, 196, 196, 64, torch.float32, None, False),
              (2, 3, 77, 77, 32, torch.float32, (77, 0), False),
              (2, 3, 130, 130, 128, torch.bfloat16, (130, 64), True)]
    for b, h, tq, tk, d, dtype, lens, causal in shapes:
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(dtype) for t in (tq, tk, tk))
        kv = None if lens is None else (
            torch.arange(tk, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
        before = ta.launches
        got = ta.flash_attention(q, k, v, kv_mask=kv, causal=causal)
        torch.cuda.synchronize()
        assert ta.launches == before + 1
        want = ta.flash_attention(q, k, v, kv_mask=kv, causal=causal,
                                  impl="torch")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
