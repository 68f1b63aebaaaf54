"""The port's serving path on the CPU (mmlspark_tpu_torch/serve).

``ModelServer.add_model`` → ``DynamicBatcher`` → ``core.plan`` →
``TorchModel`` forward, at ViT-Tiny size with the weights of the JAX
package's ``ViT_Tiny`` converted by ``models/convert.py``.

Tolerances: served answers equal the port's offline ``TorchModel.transform``
to ``atol=1e-6`` — the same module and float32 arithmetic, only the rows
packed beside each request differ. Against JAX ``JaxModel.transform`` on
the same rows, ``atol=rtol=1e-5``: float32 on both sides, differing only in
summation order (see ``tests/test_torch_vit.py``).
"""

import threading

import numpy as np
import pytest

from conftest import assert_no_leaked_threads
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.convert import vit_state_dict_from_flax
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.vit import ViT, vit_tiny
from mmlspark_tpu_torch.serve.batcher import THREAD_PREFIX
from mmlspark_tpu_torch.serve.config import ServeConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, DeadlineExceeded, ModelNotFound, Overloaded, ServerClosed,
)
from mmlspark_tpu_torch.serve.server import Client, ModelServer

SIZES = [1, 2, 3, 5, 1, 4, 7, 1, 16, 2, 3, 5]


@pytest.fixture(scope="module")
def jax_bundle():
    pytest.importorskip("jax")
    from mmlspark_tpu.models.zoo import get_model
    return get_model("ViT_Tiny", seed=0)


@pytest.fixture(scope="module")
def port_model(jax_bundle):
    import jax
    module = vit_tiny(device="cpu")
    module.load_state_dict(vit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_bundle.params)))
    bundle = ModelBundle(module.eval(), (32, 32, 3), ViT.OUTPUT_NAMES,
                         preprocess="scale_pm1", name="ViT_Tiny")
    return TorchModel(model=bundle, input_col="image", output_col="scores",
                      device="cpu")


def _images(n, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            for _ in range(n)]


def _scores(table):
    return np.stack(table["scores"])


def test_served_answers_match_offline_and_jax(port_model, jax_bundle):
    from mmlspark_tpu.data.table import DataTable as JaxTable
    from mmlspark_tpu.models.jax_model import JaxModel
    images = _images(sum(SIZES))
    offline = _scores(port_model.transform(DataTable({"image": images})))
    jax_out = _scores(JaxModel(model=jax_bundle, input_col="image",
                               output_col="scores")
                      .transform(JaxTable({"image": images})))
    np.testing.assert_allclose(offline, jax_out, rtol=1e-5, atol=1e-5)

    config = ServeConfig(buckets=(1, 4, 16))
    with ModelServer(config) as server:
        server.add_model("vit", port_model,
                         example=DataTable({"image": images[:1]}))
        # the ladder is warmed before the first request
        assert server.stats("vit").batches == 0
        handles, offset = [], 0
        for n in SIZES:
            table = DataTable({"image": images[offset:offset + n]})
            handles.append((offset, n, server.submit("vit", table)))
            offset += n
        for offset, n, handle in handles:
            got = _scores(handle.result(timeout=60))
            assert got.shape == (n, 10)
            np.testing.assert_allclose(got, offline[offset:offset + n],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got, jax_out[offset:offset + n],
                                       rtol=1e-5, atol=1e-5)
        snap = server.snapshot()["vit"]
    assert snap["completed"] == len(SIZES)
    assert snap["rows_dispatched"] == sum(SIZES)
    assert set(snap["occupancy_by_bucket"]) <= set(config.buckets)
    assert snap["failed"] == snap["expired_deadline"] == 0


def test_bundle_is_served_through_a_torch_model(port_model):
    images = _images(3, seed=1)
    want = _scores(port_model.transform(DataTable({"image": images})))
    with ModelServer(ServeConfig(buckets=(1, 4))) as server:
        server.add_model("b", port_model.model, device="cpu")
        got = Client(server).predict("b", DataTable({"input": images}))
    np.testing.assert_allclose(np.stack(got["scores"]), want, atol=1e-6)


class _Gate(Transformer):
    """A host stage that records every batch and holds it until
    released."""

    def __init__(self, released=False):
        super().__init__()
        self.release = threading.Event()
        if released:
            self.release.set()
        self.seen = []

    def transform(self, table):
        self.seen.append(np.asarray(table["x"]).tolist())
        self.release.wait(timeout=30)
        return table.with_column("out", np.asarray(table["x"]) * 2)


def _x(*values):
    return DataTable({"x": np.asarray(values, np.float64)})


def test_add_model_warms_every_bucket_before_the_first_request():
    gate = _Gate(released=True)
    with ModelServer(ServeConfig(buckets=(1, 4, 16))) as server:
        server.add_model("gate", gate, example=_x(7.0, 8.0))
        assert [len(b) for b in gate.seen] == [1, 4, 16]
        assert all(set(b) == {7.0} for b in gate.seen)
        assert server.stats("gate").batches == 0
        assert server.predict("gate", _x(1.0, 2.0, 3.0))["out"].tolist() \
            == [2.0, 4.0, 6.0]
    # the request was padded to its bucket by repeating its last row
    assert gate.seen[-1] == [1.0, 2.0, 3.0, 3.0]


def test_full_queue_raises_overloaded():
    gate = _Gate()
    server = ModelServer(ServeConfig(buckets=(1,), max_queue=2,
                                     max_inflight=1, warmup=False))
    server.add_model("gate", gate)
    admitted = []
    try:
        # with the lane held, at most one batch is in the lane, one waits
        # for its slot and max_queue wait in the queue
        with pytest.raises(Overloaded):
            for i in range(10):
                admitted.append(server.submit("gate", _x(float(i))))
        assert 2 <= len(admitted) <= 4
        assert server.stats("gate").rejected_overload == 1
    finally:
        gate.release.set()
        server.close(drain=True)
    for i, r in enumerate(admitted):
        assert r.result(timeout=5)["out"].tolist() == [2.0 * i]


def test_close_drains_every_request_and_joins_every_thread(port_model):
    images = _images(12, seed=2)
    server = ModelServer(ServeConfig(buckets=(1, 4, 16)))
    server.add_model("vit", port_model,
                     example=DataTable({"image": images[:1]}))
    handles = [server.submit("vit", DataTable({"image": images[i:i + 3]}))
               for i in range(0, 12, 3)]
    server.close(drain=True)
    for h in handles:
        assert len(h.result(timeout=1)["scores"]) == 3
    with pytest.raises(ServerClosed):
        server.submit("vit", DataTable({"image": images[:1]}))
    assert_no_leaked_threads(THREAD_PREFIX)


def test_request_errors_are_typed(port_model):
    images = _images(5, seed=3)
    with ModelServer(ServeConfig(buckets=(1, 4), warmup=False)) as server:
        server.add_model("vit", port_model)
        with pytest.raises(ModelNotFound):
            server.submit("nope", DataTable({"image": images[:1]}))
        with pytest.raises(BadRequest, match="largest bucket"):
            server.submit("vit", DataTable({"image": images}))
        with pytest.raises(BadRequest, match="empty"):
            server.submit("vit", DataTable({"image": []}))


def test_deadline_expiring_in_the_queue_cancels_before_dispatch():
    gate = _Gate()
    server = ModelServer(ServeConfig(buckets=(1,), max_inflight=1,
                                     warmup=False))
    server.add_model("gate", gate)
    try:
        held = [server.submit("gate", _x(1.0)), server.submit("gate", _x(2.0))]
        late = server.submit("gate", _x(3.0), deadline_ms=50)
        with pytest.raises(DeadlineExceeded) as err:
            late.result(timeout=10)
        assert err.value.where == "queued"
    finally:
        gate.release.set()
        server.close(drain=True)
    assert [r.result(timeout=5)["out"].tolist() for r in held] == \
        [[2.0], [4.0]]
    assert [3.0] not in gate.seen
    assert server.stats("gate").timed_out == 1


def test_a_mis_shaped_request_fails_alone(port_model):
    good = DataTable({"image": _images(2, seed=4)})
    bad = DataTable({"image": [np.zeros((16, 16, 3), np.uint8)] * 2})
    want = _scores(port_model.transform(good))
    with ModelServer(ServeConfig(buckets=(4, 16), warmup=False)) as server:
        server.add_model("vit", port_model)
        handles = [server.submit("vit", t) for t in (good, bad, good)]
        np.testing.assert_allclose(_scores(handles[0].result(timeout=60)),
                                   want, atol=1e-6)
        with pytest.raises(ValueError, match="model expects"):
            handles[1].result(timeout=60)
        np.testing.assert_allclose(_scores(handles[2].result(timeout=60)),
                                   want, atol=1e-6)
