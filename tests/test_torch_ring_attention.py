"""The port's ring attention (mmlspark_tpu_torch/parallel/ring_attention.py)
against the JAX package's ``ring_attention`` on the 8-virtual-device CPU
mesh, and the port's mesh (mmlspark_tpu_torch/parallel/mesh.py).

The port runs the ``sp`` ranks as virtual ranks on one device (a
rank-major fold, ``torch.roll`` for the collective-permute); the JAX
package runs them as ``shard_map`` over real (here virtual CPU) devices.
Same numpy-seeded operands and pad masks, causal and not, on meshes
``dp=1, sp=4``, ``dp=1, sp=8`` and ``dp=2, sp=4``. A sign slip in the
rotation passes every non-causal case, so the causal ones are the check
of the hop schedule.

Tolerance 1e-5 absolute: both sides accumulate the same online softmax in
float32, hop by hop in the same order; they differ in the summation order
of the matrix products (XLA's against PyTorch's), a few 1e-7 on outputs of
order 1. Fully masked query rows are exact zeros on both sides.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.parallel import mesh as tmesh
from mmlspark_tpu_torch.parallel.ring_attention import (
    _ring_shift, attention_reference, ring_attention,
)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.parallel import mesh as jmesh  # noqa: E402
from mmlspark_tpu.parallel import ring_attention as jring  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_meshes():
    return {spec: jmesh.make_mesh(jmesh.MeshSpec(dp=spec[0], sp=spec[1]))
            for spec in ((1, 4), (1, 8), (2, 4))}


def _operands(b, n, h, d, lengths, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(b, n, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dp,sp,lengths", [
    (1, 4, (32, 13)),
    (1, 8, (32, 7)),
    (2, 4, (32, 20, 0, 32)),
])
def test_ring_matches_the_jax_ring(jax_meshes, dp, sp, lengths, causal):
    b, n, h, d = len(lengths), 32, 2, 8
    q, k, v, mask = _operands(b, n, h, d, lengths, seed=sp + dp)
    want = np.asarray(jring.ring_attention(
        *map(jnp.asarray, (q, k, v)), jax_meshes[(dp, sp)], causal=causal,
        kv_mask=jnp.asarray(mask)))
    mesh = tmesh.make_mesh({"dp": dp, "sp": sp}, "cpu")
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                         causal=causal, kv_mask=torch.from_numpy(mask))
    assert got.shape == (b, n, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    ref = attention_reference(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    for row in np.flatnonzero(np.asarray(lengths) == 0):
        # a row with no real key: exact zeros on both sides
        assert (got[row] == 0).all() and (want[row] == 0).all()


def test_fully_masked_query_rows_are_exact_zeros():
    # a row of length 0 has no real key at all; with right padding and
    # the causal mask every other row's queries see at least key 0
    q, k, v, mask = _operands(3, 16, 2, 8, (16, 0, 3), seed=1)
    mesh = tmesh.make_mesh({"sp": 4}, "cpu")
    for causal in (True, False):
        got = ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                             causal=causal, kv_mask=torch.from_numpy(mask))
        assert (got[1] == 0).all()
        assert torch.isfinite(got).all()


def test_the_ring_keeps_the_input_dtype_and_runs_without_a_mask():
    q, k, v, _ = _operands(2, 16, 2, 8, (16, 16), seed=2)
    mesh = tmesh.make_mesh({"sp": 2}, "cpu")
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ring_attention(*t, mesh)
    assert got.dtype == torch.bfloat16
    want = attention_reference(*(x.float() for x in t))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=2 ** -7)


def test_the_ring_gradient_matches_the_single_device_attention():
    q, k, v, mask = _operands(2, 16, 2, 8, (16, 9), seed=3)
    mesh = tmesh.make_mesh({"sp": 4}, "cpu")
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32))
    grads = []
    for fn in (lambda *a: ring_attention(*a, mesh, causal=True,
                                         kv_mask=torch.from_numpy(mask)),
               lambda *a: attention_reference(
                   *a, causal=True, kv_mask=torch.from_numpy(mask))):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts) * w).sum().backward()
        grads.append([t.grad for t in ts])
    for g, want in zip(*grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_ring_shift_sends_each_block_to_the_next_rank():
    x = torch.arange(4)[:, None] * torch.ones(4, 3)
    (y,) = _ring_shift((x,))
    # rank r now holds rank r-1's block, as ppermute with perm (i, i+1)
    assert y[:, 0].tolist() == [3, 0, 1, 2]


def test_shapes_that_do_not_divide_over_the_mesh_raise():
    mesh = tmesh.make_mesh({"dp": 2, "sp": 4}, "cpu")
    q = torch.zeros(2, 10, 2, 8)
    with pytest.raises(ValueError, match="'sp'"):
        ring_attention(q, q, q, mesh)
    q = torch.zeros(3, 8, 2, 8)
    with pytest.raises(ValueError, match="'dp'"):
        ring_attention(q, q, q, mesh)


def test_mesh_resolves_like_the_jax_packages():
    for spec in (jmesh.MeshSpec(dp=2, sp=4), jmesh.MeshSpec(sp=4),
                 jmesh.MeshSpec(tp=2)):
        fields = {f: getattr(spec, f) for f in tmesh.AXES}
        port = tmesh.MeshSpec(**fields)
        assert port.resolve(8) == spec.resolve(8)
        with pytest.raises(ValueError) as want:
            spec.resolve(3)
        with pytest.raises(ValueError) as got:
            port.resolve(3)
        assert str(got.value) == str(want.value)
    assert tmesh.AXES == jmesh.AXES


def test_make_mesh_counts_virtual_ranks_on_one_device():
    mesh = tmesh.make_mesh(tmesh.MeshSpec(sp=4), "cpu")
    assert dict(mesh.shape) == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 4,
                                "pp": 1, "ep": 1}
    assert mesh.size == 4 and mesh.device == torch.device("cpu")
    assert tmesh.make_mesh(None, "cpu").size == 1
    assert tmesh.make_mesh({"dp": 2, "sp": 2}, "cpu").size == 4
    for devices in (["cuda:0", "cuda:1"], ("cpu",)):
        with pytest.raises(NotImplementedError, match="ROADMAP A2"):
            tmesh.make_mesh({"sp": 2}, devices)
    with pytest.raises(ValueError, match="at most one -1"):
        tmesh.make_mesh(tmesh.MeshSpec(dp=-1, sp=-1), "cpu")
