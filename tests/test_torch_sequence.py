"""The port's causal TransformerTagger (mmlspark_tpu_torch/models/sequence.py)
against the JAX package's flax module, on the same weights
(``sequence_state_dict_from_flax``) and numpy-seeded tokens.

Tolerance 1e-5 absolute: both compute in float32 with the same LayerNorm
(eps 1e-6, one-pass statistics), tanh GELU and masked softmax; XLA and
PyTorch sum the matrix products in other orders, which moves logits of
magnitude about 1 by a few 1e-7 per layer.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.convert import sequence_state_dict_from_flax
from mmlspark_tpu_torch.models.sequence import (
    TransformerTagger, init_sequence_,
)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.models.sequence import TransformerTagger as JaxTagger  # noqa: E402

ATOL = 1e-5
KW = dict(vocab_size=97, embed_dim=32, num_heads=4, num_layers=2,
          mlp_dim=64, num_tags=97, max_len=64, causal=True)
HD = KW["embed_dim"] // KW["num_heads"]


@pytest.fixture(scope="module")
def models():
    jm = JaxTagger(**KW)
    params = jm.init(jax.random.PRNGKey(0),
                     np.zeros((1, 8), np.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerTagger(device="cpu", **KW)
    tm.load_state_dict(sequence_state_dict_from_flax(params))
    return jm, params, tm.eval()


def _tokens(b, n, seed=0):
    return np.random.default_rng(seed).integers(
        1, KW["vocab_size"], (b, n)).astype(np.int32)


def test_full_forward_and_cache_match_flax(models):
    jm, params, tm = models
    toks = _tokens(3, 12)
    mask = np.arange(12)[None, :] < np.array([12, 5, 9])[:, None]
    jl, (jk, jv) = jm.apply({"params": params}, toks, mask=mask,
                            return_cache=True)
    with torch.no_grad():
        tl, (tk, tv) = tm(torch.from_numpy(toks),
                          mask=torch.from_numpy(mask), return_cache=True)
    assert tl.shape == (3, 12, KW["num_tags"])
    assert tk.shape == tv.shape == (3, KW["num_layers"], KW["num_heads"],
                                    12, HD)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=ATOL)
    # the plain forward (no cache) gives the same logits bit for bit
    with torch.no_grad():
        again = tm(torch.from_numpy(toks), mask=torch.from_numpy(mask))
    assert torch.equal(again, tl)


def _cache(tm, toks, lengths, t_max):
    """A slot-major cache ``[S, layers, H, t_max, hd]`` prefilled with the
    port's K/V of ``toks`` (zeros past each prompt's bucket)."""
    s_, n = toks.shape
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    with torch.no_grad():
        _, (pk, pv) = tm(torch.from_numpy(toks), mask=torch.from_numpy(mask),
                         return_cache=True)
    ck = torch.zeros(s_, KW["num_layers"], KW["num_heads"], t_max, HD)
    cv = torch.zeros_like(ck)
    ck[:, :, :, :n] = pk
    cv[:, :, :, :n] = pv
    return ck, cv


def test_decode_step_matches_flax_and_writes_only_active_rows(models):
    jm, params, tm = models
    lengths = np.array([12, 5, 9])
    ck, cv = _cache(tm, _tokens(3, 12), lengths, t_max=16)
    before_k, before_v = ck.clone(), cv.clone()
    positions = lengths.astype(np.int32)
    active = np.array([True, False, True])
    new = _tokens(3, 1, seed=1)
    jl, (jk, jv) = jm.apply(
        {"params": params}, new, cache=(jnp.asarray(ck.numpy()),
                                        jnp.asarray(cv.numpy())),
        positions=jnp.asarray(positions), update_mask=jnp.asarray(active))
    with torch.no_grad():
        tl, (ck2, cv2) = tm.decode_step(
            torch.from_numpy(new), (ck, cv), torch.from_numpy(positions),
            update_mask=torch.from_numpy(active))
    assert ck2 is ck and cv2 is cv  # updated in place
    assert tl.shape == (3, KW["num_tags"])
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               rtol=0, atol=ATOL)
    # the inactive slot keeps its cache bits
    assert torch.equal(ck[1], before_k[1]) and torch.equal(cv[1], before_v[1])
    for s in np.nonzero(active)[0]:
        p = positions[s]
        # the active rows are written at their position, nothing else moves
        np.testing.assert_allclose(ck[s, :, :, p].numpy(),
                                   np.asarray(jk)[s, :, :, p], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(cv[s, :, :, p].numpy(),
                                   np.asarray(jv)[s, :, :, p], rtol=0,
                                   atol=ATOL)
        assert not torch.equal(ck[s, :, :, p], before_k[s, :, :, p])
        others = [t for t in range(16) if t != p]
        assert torch.equal(ck[s, :, :, others], before_k[s, :, :, others])
        assert torch.equal(cv[s, :, :, others], before_v[s, :, :, others])


def test_decode_step_equals_the_full_forward_at_the_next_position(models):
    """Prefill n tokens, decode token n+1: its logits are the full
    forward's at position n (every slot active, update_mask None)."""
    _, _, tm = models
    toks = _tokens(2, 10, seed=2)
    n = 7
    ck, cv = _cache(tm, toks[:, :n], [n, n], t_max=12)
    with torch.no_grad():
        full = tm(torch.from_numpy(toks[:, :n + 1]))[:, n]
        step, _ = tm.decode_step(torch.from_numpy(toks[:, n:n + 1]),
                                 (ck, cv), torch.tensor([n, n]))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=0,
                               atol=ATOL)


def test_seeded_init_is_reproducible_and_flax_shaped():
    a = init_sequence_(TransformerTagger(device="cpu", **KW),
                       torch.Generator().manual_seed(3))
    b = init_sequence_(TransformerTagger(device="cpu", **KW),
                       torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    blk = a.blocks[0]
    assert torch.equal(blk.ln_a.weight, torch.ones(KW["embed_dim"]))
    assert torch.equal(blk.qkv.bias, torch.zeros(3 * KW["embed_dim"]))
    # truncated LeCun normal: |w| within two stddevs of sqrt(1/fan_in)
    bound = 2 * (1 / KW["embed_dim"]) ** 0.5 / 0.87962566103423978
    assert float(blk.qkv.weight.detach().abs().max()) <= bound


GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_heads=12,
                  num_layers=12, mlp_dim=3072, num_tags=50257, max_len=1024,
                  causal=True)


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerTagger(**KW)


def test_gpt2_small_widths():
    """The published GPT-2 small widths (weights left uninitialised):
    about 163 M parameters, the head untied."""
    model = TransformerTagger(device="cpu", **GPT2_SMALL)
    n = sum(p.numel() for p in model.parameters())
    assert 162e6 < n < 164e6
    assert model.head_dim == 64 and model.causal


def test_max_len_and_head_divisibility_are_checked(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="max_len"):
        tm(torch.zeros(1, KW["max_len"] + 1, dtype=torch.long))
    with pytest.raises(ValueError, match="divisible"):
        TransformerTagger(embed_dim=30, num_heads=4, device="cpu")
