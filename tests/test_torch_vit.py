"""The port's ViT (mmlspark_tpu_torch/models/vit.py) against the JAX ViT.

flax ``vit_tiny`` params from ``init_bundle`` are converted by
``models/convert.py``; the same numpy-seeded inputs go through the JAX
module and the port on the CPU. The JAX side runs attention as
``"flash_xla"`` (the online-softmax reference) and as ``"bhtd"`` (scores,
softmax, weighted sum); the port as ``"flash"`` (on CPU tensors, its plain
PyTorch version) and ``"einsum"``.

Tolerances:

* float32: ``atol=rtol=1e-5``. Both sides compute every product and
  statistic in float32 and differ only in summation order (XLA's dot vs
  PyTorch's CPU GEMM): measured at most 1.2e-6 on these inputs.
* bfloat16: ``atol=rtol=2e-2``. Both sides cast params and activations to
  bfloat16 at the same places, but each rounds a product or a sum to
  bfloat16 (8 bits of mantissa, a step of 0.4% of the value) after
  accumulating in its own order, so a value may land one or two bfloat16
  steps apart, and the residual stream carries that on. Measured on these
  inputs: at most 9.8e-3 (logits and features), 7.8e-3 (attention) and
  3.1e-2 (one encoder block, one step at |x| = 4.3).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mmlspark_tpu.models import vit as jvit  # noqa: E402
from mmlspark_tpu.models.zoo import init_bundle  # noqa: E402
from mmlspark_tpu_torch.models import vit as tvit  # noqa: E402
from mmlspark_tpu_torch.models.convert import (  # noqa: E402
    vit_state_dict_from_flax,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# port attention impl for each JAX attn_impl
PORT_IMPL = {"flash_xla": "flash", "bhtd": "einsum"}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """flax params as numpy arrays; cached, so callers must not mutate."""
    bundle = init_bundle(jvit.vit_tiny(), (32, 32, 3), "ViT_Tiny",
                         preprocess="scale_pm1", seed=seed)
    return jax.tree_util.tree_map(np.asarray, bundle.params)


def _port_vit(params, dtype, impl):
    model = tvit.vit_tiny(dtype=dtype, attn_impl=impl, device="cpu")
    model.load_state_dict(vit_state_dict_from_flax(params))
    return model.eval()


def _images(n=3, seed=0):
    r = np.random.default_rng(seed)
    return r.uniform(-1.0, 1.0, size=(n, 32, 32, 3)).astype(np.float32)


def _tol(dtype_name):
    return F32_TOL if dtype_name == "f32" else BF16_TOL


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("jax_impl", ["flash_xla", "bhtd"])
def test_vit_features_and_logits_match_jax(jax_impl, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    params = _params()
    x = _images()
    jmod = jvit.vit_tiny(dtype=jdt, attn_impl=jax_impl)
    model = _port_vit(params, tdt, PORT_IMPL[jax_impl])
    with torch.inference_mode():
        for node in ("features", "logits"):
            want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                         output=node))
            got = model(torch.from_numpy(x), output=node)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want,
                                       **_tol(dtype_name))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("jax_impl", ["flash_xla", "bhtd"])
def test_attention_module_matches_jax(jax_impl, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    params = _params(seed=1)
    x = np.random.default_rng(2).normal(size=(2, 16, 64)).astype(np.float32)
    jattn = jvit.BhtdSelfAttention(
        heads=4, dtype=jdt,
        impl="einsum" if jax_impl == "bhtd" else jax_impl)
    want = np.asarray(jattn.apply({"params": params["block0"]["attn"]},
                                  jnp.asarray(x, jdt)), np.float32)
    attn = _port_vit(params, tdt, PORT_IMPL[jax_impl]).blocks[0].attn
    with torch.inference_mode():
        got = attn(torch.from_numpy(x).to(tdt)).float().numpy()
    np.testing.assert_allclose(got, want, **_tol(dtype_name))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("jax_impl", ["flash_xla", "bhtd"])
def test_encoder_block_matches_jax(jax_impl, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    params = _params(seed=3)
    x = np.random.default_rng(4).normal(size=(2, 16, 64)).astype(np.float32)
    jblock = jvit.EncoderBlock(64, 4, 128, dtype=jdt, attn_impl=jax_impl)
    want = np.asarray(jblock.apply({"params": params["block1"]},
                                   jnp.asarray(x, jdt)), np.float32)
    block = _port_vit(params, tdt, PORT_IMPL[jax_impl]).blocks[1]
    with torch.inference_mode():
        got = block(torch.from_numpy(x).to(tdt)).float().numpy()
    np.testing.assert_allclose(got, want, **_tol(dtype_name))


def test_converted_state_dict_covers_every_port_parameter():
    params = _params()
    sd = vit_state_dict_from_flax(params)
    model = tvit.vit_tiny(device="cpu")
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name


def test_patch_embedding_flattens_in_row_order():
    """A patch at grid cell (h, w) lands at token h * grid + w, matching
    the JAX ``reshape(B, h*w, dim)`` of the NHWC conv output, so
    ``pos_embed`` rows line up."""
    model = tvit.vit_tiny(device="cpu")
    with torch.no_grad():
        model.patch_embed.weight.zero_()
        model.patch_embed.bias.zero_()
        model.patch_embed.weight[0, 0, 0, 0] = 1.0   # reads pixel (0, 0)
        x = torch.zeros(1, 32, 32, 3)
        x[0, 8 * 1, 8 * 2, 0] = 1.0                  # grid cell (1, 2)
        tokens = model.embed_patches(x)
    assert tuple(tokens.shape) == (1, 16, 64)
    assert tokens[0, :, 0].nonzero().flatten().tolist() == [1 * 4 + 2]


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="unknown attention impl"):
        tvit.vit_tiny(attn_impl="pallas", device="cpu")
