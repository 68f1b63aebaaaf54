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
and skips here. Its order of sums (each slot's valid key range cut into
8 warp chunks, walked in stages of 8 keys with 4 lanes a key, then the
warps merged in a fixed order) is emulated in float32 below and held
against the JAX package's implementations at the kernel's chunk and
stage boundaries.
"""

import ctypes
import os
import re

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
    q view), the edge cases and the kernel's chunk and stage boundaries
    (valid lengths 0, 1, 31, 32, 33, 320 and 1024, holes and a long gap),
    each launched twice (equal bit for bit); then one slot's output
    unchanged bit for bit when every other slot's q, K, V and mask rows
    are replaced. Tolerance 1e-5: both run in float32 from the same
    operands and differ in summation order and in ``expf`` against
    ``torch.exp``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    gap = torch.zeros(1024, dtype=torch.bool)
    gap[[3, 5, 6, 517, 900, 1023]] = True
    for s, h, tk, d, lens in [(32, 12, 1024, 64, None),
                              (4, 2, 37, 16, (0, 1, 17, 37)),
                              (3, 4, 300, 128, (300, 0, 33)),
                              (2, 3, 65, 40, (65, 64)),
                              (8, 12, 1024, 64, EDGE_LENGTHS + ("gap",))]:
        cache = torch.randn(s, 2, h, tk, d, generator=gen, device=dev)
        k, v = cache[:, 0], cache[:, 1]
        qkv = torch.randn(s, 3 * h * d, generator=gen, device=dev)
        q = qkv[:, :h * d].reshape(s, h, d)
        kv = None
        if lens is not None:
            kv = torch.stack([gap if n == "gap" else torch.arange(tk) < n
                              for n in lens]).to(dev)
        before = ta.decode_launches
        got = ta.decode_attention(q, k, v, kv_mask=kv)
        again = ta.decode_attention(q, k, v, kv_mask=kv)
        torch.cuda.synchronize()
        assert ta.decode_launches == before + 2
        assert torch.equal(got, again)
        want = ta.decode_attention(q, k, v, kv_mask=kv, impl="torch")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        if lens is not None and 0 in lens:
            assert (got[lens.index(0)] == 0).all()
    # slot 5 (320 keys) alone keeps its inputs; every other row is new
    q2, k2, v2, kv2 = (t.clone() for t in (q, k, v, kv))
    others = [i for i in range(s) if i != 5]
    q2[others] = torch.randn(q2[others].shape, generator=gen, device=dev)
    k2[others] = torch.randn(k2[others].shape, generator=gen, device=dev)
    v2[others] = torch.randn(v2[others].shape, generator=gen, device=dev)
    kv2[others] = torch.rand(kv2[others].shape, generator=gen,
                             device=dev) < 0.5
    alone = ta.decode_attention(q2, k2, v2, kv_mask=kv2)
    assert torch.equal(alone[5], got[5])


# ---- decode_fwd_kernel's order of sums, emulated in float32 ----

WARPS, KPS, LPK = 8, 8, 4  # warps a block, keys a stage, lanes a key
EDGE_TK = 1024
# valid lengths at the kernel's chunk and stage boundaries
EDGE_LENGTHS = (0, 1, 31, 32, 33, 320, 1024)
EDGE_TOL = 1e-5  # chip_smoke.py's DECODE_TOL


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32 (two,
    in the rare case the float64 sum rounds first)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _kernel_order(q, k, v, keep, scale, skip=True):
    """decode_fwd_kernel in float32, sum for sum: the slot's valid range
    [lo, hi) from its own mask row, cut into WARPS chunks of ceil(n /
    WARPS) keys; each chunk walked in stages of KPS keys (a stage with no
    valid key skipped when ``skip``); a key's score as LPK lane parts,
    part p summing the 16-byte chunks p, p + 4, ... by fmaf and the parts
    added pairwise; the stage's p summed as a tree; acc scaled, then one
    fmaf a key; the warps merged in order 0 .. WARPS-1."""
    s_, h, d = q.shape
    d4 = d // 4
    scale = np.float32(scale)
    out = np.zeros((s_, h, d), np.float32)
    for s in range(s_):
        valid = np.flatnonzero(keep[s])
        if valid.size == 0:
            continue  # every warp at m = -inf: 0 / 1e-30
        lo, hi = valid[0], valid[-1] + 1
        cw = -(-(hi - lo) // WARPS)
        states = []
        for w in range(WARPS):
            m = np.full(h, -np.inf, np.float32)
            den = np.zeros(h, np.float32)
            acc = np.zeros((h, d), np.float32)
            beg = lo + w * cw
            end = min(beg + cw, hi)
            for t0 in range(beg, end, KPS):
                kn = min(KPS, end - t0)
                kp = keep[s, t0:t0 + kn] != 0
                if skip and not kp.any():
                    continue
                rows = k[s, :, t0:t0 + kn]                  # [h, kn, d]
                parts = []
                for p in range(LPK):
                    a = np.zeros((h, kn), np.float32)
                    for j in range(p, d4, LPK):
                        for e in range(4 * j, 4 * j + 4):
                            a = _fma(q[s, :, e, None], rows[..., e], a)
                    parts.append(a)
                dot = (parts[0] + parts[1]) + (parts[2] + parts[3])
                sc = np.where(kp, dot * scale, np.float32(-np.inf))
                m_new = np.maximum(m, sc.max(axis=-1))
                with np.errstate(invalid="ignore"):
                    corr = np.where(np.isfinite(m), np.exp(m - m_new),
                                    np.float32(0))
                    p = np.where(kp, np.exp(sc - m_new[:, None]),
                                 np.float32(0))
                psum = np.zeros((h, KPS), np.float32)
                psum[:, :kn] = p
                while psum.shape[1] > 1:  # lanes xor 4, 8, 16
                    psum = psum[:, 0::2] + psum[:, 1::2]
                den = _fma(den, corr, psum[:, 0])
                acc = acc * corr[:, None]
                for c in range(kn):
                    acc = _fma(p[:, c, None], v[s, :, t0 + c], acc)
                m = m_new
            states.append((m, den, acc))
        mx = np.max([st[0] for st in states], axis=0)
        a = np.zeros((h, d), np.float32)
        den = np.zeros(h, np.float32)
        for m_w, l_w, acc_w in states:
            with np.errstate(invalid="ignore"):
                c_w = np.where(np.isfinite(m_w), np.exp(m_w - mx),
                               np.float32(0))
            a = _fma(acc_w, c_w[:, None], a)
            den = _fma(l_w, c_w, den)
        out[s] = a / np.maximum(den, np.float32(1e-30))[:, None]
    return out


def _edge_inputs(d, seed=7):
    """Slots at the boundary lengths, then two rows with holes: one with a
    long gap (most of its stages all masked) and one at random."""
    r = np.random.default_rng(seed)
    h = 2
    s_ = len(EDGE_LENGTHS) + 2
    q = r.normal(size=(s_, h, d)).astype(np.float32)
    k = r.normal(size=(s_, h, EDGE_TK, d)).astype(np.float32)
    v = r.normal(size=(s_, h, EDGE_TK, d)).astype(np.float32)
    mask = np.arange(EDGE_TK)[None, :] < np.array(
        EDGE_LENGTHS + (0, 0))[:, None]
    mask[-2, [3, 5, 6, 517, 900, 1023]] = True
    mask[-1] = r.random(EDGE_TK) < 0.3
    return q, k, v, mask


@pytest.mark.parametrize("d", [16, 40])
def test_kernel_order_of_sums_matches_jax_at_chunk_boundaries(d):
    """The kernel's arithmetic, emulated in float32, against the JAX
    package's plain route (its numpy oracle ``decode_attention_host``) and
    the port's plain version, within the card's 1e-5 (DECODE_TOL), at
    valid lengths 0, 1, 31, 32, 33, 320 and 1024 and two masks with
    holes; empty slots exact zeros. D = 40 leaves the lane parts uneven
    (chunks 0..9: parts 0 and 1 take three, parts 2 and 3 two)."""
    pytest.importorskip("jax")
    from mmlspark_tpu.ops.pallas import attention as fa
    q, k, v, mask = _edge_inputs(d)
    s_ = q.shape[0]
    sc = ta.resolve_scale(None, d)
    got = _kernel_order(q, k, v, mask, sc)
    with np.errstate(invalid="ignore"):  # its -inf guards, as written
        host = fa.decode_attention_host(
            q, k, v, fa.host_decode_mask2(s_, EDGE_TK, mask), sc)
    plain = ta.decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        ta.decode_mask2(s_, EDGE_TK, torch.from_numpy(mask), "cpu"),
        sc).numpy()
    for want in (host, plain):
        np.testing.assert_allclose(got, want, rtol=0, atol=EDGE_TOL)
    for i in np.flatnonzero(~mask.any(axis=1)):
        assert (got[i] == 0).all() and (plain[i] == 0).all()
    assert np.isfinite(got).all()


def test_stage_skip_is_exact():
    """Skipping a stage whose keys are all masked gives the bits of
    walking it: the -inf guards make such a stage a no-op."""
    q, k, v, mask = _edge_inputs(16, seed=8)
    rows = slice(len(EDGE_LENGTHS), None)  # the two masks with holes
    args = (q[rows], k[rows], v[rows], mask[rows], ta.resolve_scale(None, 16))
    np.testing.assert_array_equal(_kernel_order(*args),
                                  _kernel_order(*args, skip=False))


def test_kernel_entry_takes_the_arguments_the_wrapper_passes():
    """The C signature of ``decode_attention_fwd`` against the ctypes types
    the wrapper sets: the same count and kind of every argument (a
    mismatch would show only on the card)."""
    src = os.path.join(os.path.dirname(ta.__file__), "csrc",
                       "decode_attention.cu")
    with open(src) as f:
        text = f.read()
    sig = re.search(r"int decode_attention_fwd\(([^)]*)\)", text).group(1)
    kinds = []
    for param in (p.strip() for p in sig.split(",")):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        elif param.startswith("long long "):
            kinds.append(ctypes.c_longlong)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(param)
    assert kinds == ta._DECODE_ARGTYPES
