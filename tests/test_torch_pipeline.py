"""The port's Pipeline and segment planner against the JAX package's, on
the CPU (``mmlspark_tpu/core/plan.py`` and ``tests/test_plan.py``'s parity
pipelines, over the stages the port has).

Each pipeline is built twice from one description, from the JAX package's
stages and from the port's, run over the same numpy-seeded table, and
the two are held to each other: the same ``describe_plan`` segments, the
same crossings, the same columns, and values to the tolerances below.

* image assembly, crop, flip and unroll at scale 1: bit for bit;
* resize: within ``RESIZE_TOL`` = 1 count (the two round ``v + 0.5`` of a
  float32 blend that a compiler may contract into FMAs on one side);
* float32 forwards (a small MLP over raw pixels): ``F32_TOL`` = 1e-5 of
  the output's largest magnitude, some tens of float32 steps (XLA fuses
  and reorders the JAX side's sums); unroll with a scale and offset
  (values below 1): ``F32_TOL`` absolute.
"""

import types

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import plan as jax_plan
from mmlspark_tpu.core.pipeline import PipelineModel as JaxPipelineModel
from mmlspark_tpu.core.schema import make_image as jax_make_image
from mmlspark_tpu.core.stage import LambdaTransformer
from mmlspark_tpu.data.table import DataTable as JaxTable
from mmlspark_tpu.models.bundle import ModelBundle as JaxBundle
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.zoo import MLP as JaxMLP
from mmlspark_tpu.stages import image as jax_image

from mmlspark_tpu_torch.core import plan
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel
from mmlspark_tpu_torch.core.schema import make_image
from mmlspark_tpu_torch.core.stage import Estimator, Transformer
from mmlspark_tpu_torch.data.table import DataTable
from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.stages.image import ImageTransformer, UnrollImage

RESIZE_TOL = 1
F32_TOL = 1e-5


class MLP(torch.nn.Module):
    """The JAX zoo's ``MLP`` (dense → ReLU → head, float32) with its
    weights taken from the flax param tree."""

    OUTPUT_NAMES = ("features", "logits")

    def __init__(self, params):
        super().__init__()
        t = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v).copy()))
             for k, v in (("w0", params["dense0"]["kernel"]),
                          ("b0", params["dense0"]["bias"]),
                          ("w1", params["head"]["kernel"]),
                          ("b1", params["head"]["bias"]))}
        self.w0, self.b0, self.w1, self.b1 = t["w0"], t["b0"], t["w1"], t["b1"]

    def forward(self, x, output="logits"):
        h = torch.relu(x.float() @ self.w0 + self.b0)
        return h if output == "features" else h @ self.w1 + self.b1


def _bundles(in_dim, out_dim=4, seed=0):
    module = JaxMLP(features=(8,), num_outputs=out_dim)
    params = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(seed), np.zeros((1, in_dim), np.float32))
        ["params"])
    return (JaxBundle(module=module, params=params, input_spec=(in_dim,),
                      output_names=MLP.OUTPUT_NAMES),
            ModelBundle(MLP(params), (in_dim,), MLP.OUTPUT_NAMES, name="MLP"))


class Fn(Transformer):
    """A host stage applying a table → table function (the port has no
    LambdaTransformer; this test's own)."""

    def __init__(self, fn=None, **kw):
        super().__init__(**kw)
        self.fn = fn

    def transform(self, table):
        return self.fn(table)


JAX = types.SimpleNamespace(
    IT=jax_image.ImageTransformer, Unroll=jax_image.UnrollImage,
    Fn=lambda fn: LambdaTransformer(fn=fn), Table=JaxTable,
    image=jax_make_image,
    Model=lambda b, **kw: JaxModel(model=b[0], mesh_spec={"dp": 1}, **kw))
PORT = types.SimpleNamespace(
    IT=lambda **kw: ImageTransformer(device="cpu", **kw),
    Unroll=lambda **kw: UnrollImage(device="cpu", **kw), Fn=Fn,
    Table=DataTable, image=make_image,
    Model=lambda b, **kw: TorchModel(model=b[1], device="cpu", **kw))


def image_tables(n=10, h=24, w=18, seed=0):
    r = np.random.default_rng(seed)
    pixels = [r.integers(0, 255, (h, w, 3)) for _ in range(n)]
    return tuple(m.Table({"image": [m.image(f"p{k}", p)
                                    for k, p in enumerate(pixels)]})
                 for m in (JAX, PORT))


def structure(segments):
    return [(kind, [type(s).__name__.replace("TorchModel", "Model")
                    .replace("JaxModel", "Model")
                    .replace("LambdaTransformer", "Fn")
                    for s in stages]) for kind, stages in segments]


def run_both(build, tables):
    """(JAX result, port result, port crossings) of the pipeline
    ``build(namespace)`` describes, after checking that both sides plan
    the same segments, cross as often and write the same columns."""
    out = []
    for m, t in zip((JAX, PORT), tables):
        stages = build(m)
        p = jax_plan if m is JAX else plan
        segs = structure(p.describe_plan(stages, t))
        with p.count_crossings() as c:
            got = (JaxPipelineModel if m is JAX else PipelineModel)(
                stages).transform(t)
        out.append((segs, got, c))
    (jsegs, jgot, jc), (segs, got, c) = out
    assert segs == jsegs
    assert got.columns == jgot.columns
    assert (c.uploads, c.fetches) == (jc.uploads, jc.fetches)
    return jgot, got, c


def images_gap(a, b):
    return max((np.abs(x["data"].astype(int) - y["data"].astype(int)).max()
                for x, y in zip(a, b)), default=0)


def assert_images_match(got, want, tol=0):
    assert images_gap(got, want) <= tol
    assert [(v["path"], v["height"], v["width"], v["channels"])
            for v in got] == [(v["path"], v["height"], v["width"],
                               v["channels"]) for v in want]


def vectors(col):
    return np.stack(list(col))


def rel_gap(got, want):
    """max |got − want| over max |want|."""
    got, want = vectors(got), vectors(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- image pipelines ----

@pytest.mark.parametrize("case", ["crop_flip", "resize", "affine_rgb"])
def test_image_pipelines_match_jax(case):
    build, kw, tol, ftol = {
        "crop_flip": (lambda m: [m.IT().crop(2, 3, 16, 12).flip(-1),
                                 m.Unroll()], {}, 0, 0.0),
        "resize": (lambda m: [m.IT().resize(16, 12), m.Unroll()],
                   dict(h=29, w=23), RESIZE_TOL, 1.0),
        "affine_rgb": (lambda m: [m.IT().flip(1),
                                  m.Unroll(scale=1 / 255.0, offset=-0.5,
                                           to_rgb=True)], {}, 0, F32_TOL),
    }[case]
    tables = image_tables(**kw)
    want, got, c = run_both(build, tables)
    assert c.uploads == 1 and c.upload_shapes == {(10,) + (
        (29, 23, 3) if case == "resize" else (24, 18, 3))}
    assert_images_match(got["image"], want["image"], tol)
    assert np.abs(vectors(got["features"])
                  - vectors(want["features"])).max() <= ftol  # absolute
    assert got.meta["image"] == {"is_image": True}
    # the fused table equals the port's own stage-by-stage one
    ref = tables[1]
    for s in build(PORT):
        ref = s.transform(ref)
    assert_images_match(got["image"], ref["image"], tol)


def test_three_stage_pipeline_with_model_and_tail_padding():
    # 10 rows at minibatch 4: two full minibatches and a padded tail
    tables = image_tables(n=10, h=12, w=10)
    bundles = _bundles(12 * 10 * 3)

    def build(m):
        return [m.IT().flip(0), m.Unroll(),
                m.Model(bundles, input_col="features", output_col="scores",
                        minibatch_size=4)]

    want, got, c = run_both(build, tables)
    assert c.uploads == 3 and c.fetches == 3
    assert_images_match(got["image"], want["image"])
    np.testing.assert_array_equal(vectors(got["features"]),
                                  vectors(want["features"]))
    assert rel_gap(got["scores"], want["scores"]) <= F32_TOL


def test_chained_models_fuse_on_vector_column():
    r = np.random.default_rng(3)
    x = list(r.normal(size=(9, 6)).astype(np.float32))
    b1, b2 = _bundles(6, out_dim=5, seed=1), _bundles(5, out_dim=3, seed=2)

    def build(m):
        return [m.Model(b1, input_col="x", output_col="h", minibatch_size=4),
                m.Model(b2, input_col="h", output_col="scores",
                        minibatch_size=4)]

    want, got, c = run_both(build, (JaxTable({"x": x}),
                                    DataTable({"x": x})))
    assert c.uploads == 3
    for col in ("h", "scores"):
        assert rel_gap(got[col], want[col]) <= F32_TOL


# ---- mixed host/device stages and the fallbacks ----

def test_mixed_host_device_pipeline():
    tables = image_tables(n=6)

    def build(m):
        return [m.Fn(lambda t: t.with_column("tag", [1] * len(t))),
                m.IT().flip(1), m.Unroll(),
                m.Fn(lambda t: t.with_column(
                    "features", [v * 2.0 for v in t["features"]]))]

    want, got, c = run_both(build, tables)
    assert structure(plan.describe_plan(build(PORT), tables[1])) == [
        ("host", ["Fn"]), ("device", ["ImageTransformer", "UnrollImage"]),
        ("host", ["Fn"])]
    assert c.uploads == 1
    np.testing.assert_array_equal(vectors(got["features"]),
                                  vectors(want["features"]))
    np.testing.assert_array_equal(got["tag"], want["tag"])


@pytest.mark.parametrize("case", ["lone_stage", "unsupported_op", "ragged",
                                  "empty"])
def test_fallbacks_give_the_jax_tables(case):
    """A lone device stage, an op with no device step, ragged images and an
    empty table run the same stages on the host: no upload, the JAX
    package's table."""
    if case == "ragged":
        r = np.random.default_rng(5)
        pixels = [r.integers(0, 255, (10 + k, 8, 3)) for k in range(5)]
        tables = tuple(m.Table({"image": [m.image(f"p{k}", p) for k, p in
                                          enumerate(pixels)]})
                       for m in (JAX, PORT))
    elif case == "empty":
        tables = (JaxTable({"image": []}), DataTable({"image": []}))
    else:
        tables = image_tables(n=4)
    build = {
        "lone_stage": lambda m: [m.IT().flip(1)],
        "unsupported_op": lambda m: [m.IT().blur(3, 3), m.Unroll()],
        "ragged": lambda m: [m.IT().flip(1), m.Unroll()],
        "empty": lambda m: [m.IT().flip(1), m.Unroll()],
    }[case]
    if case == "unsupported_op":
        pytest.importorskip("cv2")
    want, got, c = run_both(build, tables)
    assert c.uploads == 0 and len(got) == len(want)
    if case != "empty":
        assert_images_match(got["image"], want["image"])
    if "features" in want.columns:
        for a, b in zip(got["features"], want["features"]):
            np.testing.assert_array_equal(a, b)


def test_explain_says_why_a_segment_breaks():
    _, table = image_tables(n=2)
    why: list = []
    seg = plan.collect_segment(
        [ImageTransformer(device="cpu").blur(3, 3), UnrollImage()], 0,
        lambda col: plan._entry_meta(table, col), explain=why)
    assert seg is None and "declined the incoming layout" in why[0]
    why.clear()
    assert plan.collect_segment([ImageTransformer().flip(1)], 0,
                                lambda col: plan._entry_meta(table, col),
                                explain=why) is None
    assert "lone device stage" in why[0]


# ---- the segment cache, the serving entry, devices ----

def test_segment_cache_reused_and_invalidated():
    _, table = image_tables(n=6)
    it = ImageTransformer(device="cpu").flip(1)
    stages = [it, UnrollImage()]
    pm = PipelineModel(stages)
    pm.transform(table)
    cache = pm.__dict__["_plan_cache"]
    assert len(cache) == 1
    entry = next(iter(cache.values()))
    pm.transform(table)
    assert next(iter(cache.values())) is entry  # cache hit
    # a changed stage config invalidates through the cache token
    it.set(ops=list(it.ops) + [{"op": "flip", "flip_code": 0}])
    fused = pm.transform(table)
    assert next(iter(cache.values())) is not entry
    ref = table
    for s in stages:
        ref = s.transform(ref)
    np.testing.assert_array_equal(vectors(fused["features"]),
                                  vectors(ref["features"]))
    assert plan.predict_segment_minibatches(
        plan._collect_segment(stages, 0, table), 150) == 3


def test_transform_async_dispatches_the_trailing_segment():
    _, table = image_tables(n=10, h=12, w=10)
    bundles = _bundles(12 * 10 * 3)
    model = PORT.Model(bundles, input_col="features", output_col="scores",
                       minibatch_size=4)
    stages = [Fn(lambda t: t.with_column("tag", [0] * len(t))),
              PORT.IT().flip(1), PORT.Unroll(), model]
    with plan.count_crossings() as c:
        pending = plan.transform_async(stages, table)
        assert c.uploads == 3 and pending.shapes == ((4, 12, 10, 3),) * 3
        got = pending.result()
    assert pending.result() is got and c.fetches == 3
    ref = plan.execute_stages(stages, table)
    np.testing.assert_array_equal(vectors(got["scores"]),
                                  vectors(ref["scores"]))
    # a lone model stage is dispatched too (the serving case), with the
    # answers its own transform gives
    unrolled = ref.take(np.arange(5))
    lone = plan.transform_async([model], unrolled)
    assert lone.shapes == ((4, 360), (4, 360))
    np.testing.assert_array_equal(
        vectors(lone.result()["scores"]),
        vectors(model.transform(unrolled)["scores"]))


def test_stages_of_one_segment_must_name_one_device():
    _, table = image_tables(n=2)
    with pytest.raises(ValueError, match="different devices"):
        PipelineModel([ImageTransformer(device="cpu").flip(1),
                       UnrollImage(device="cuda")]).transform(table)


# ---- Pipeline.fit and persistence ----

class _Offset(Estimator):
    """Fits the mean of the first feature and yields a host stage that
    subtracts it (a fitted estimator between device stages)."""

    def fit(self, table):
        mean = float(np.mean([v[0] for v in table["features"]]))
        return Fn(lambda t: t.with_column(
            "features", [v - mean for v in t["features"]]))


def test_pipeline_fit_fits_estimators_on_the_running_table():
    _, table = image_tables(n=4)
    model = Pipeline([PORT.IT().flip(1), PORT.Unroll(), _Offset()]).fit(table)
    assert [type(s).__name__ for s in model.stages] == [
        "ImageTransformer", "UnrollImage", "Fn"]
    out = model.transform(table)
    assert abs(np.mean([v[0] for v in out["features"]])) < 1e-4
    with pytest.raises(TypeError, match="neither a Transformer"):
        Pipeline([PORT.IT(), object()]).fit(table)


def test_pipeline_model_survives_save_load_after_fusion(tmp_path):
    _, table = image_tables(n=4, h=12, w=10)
    bundles = _bundles(12 * 10 * 3)
    pm = PipelineModel([PORT.IT().flip(1), PORT.Unroll(),
                        PORT.Model(bundles, input_col="features",
                                   output_col="scores", minibatch_size=4)])
    before = pm.transform(table)  # fills the segment cache
    assert "_plan_cache" in pm.__dict__
    pm.save(str(tmp_path / "pm"))
    loaded = PipelineModel.load(str(tmp_path / "pm"))
    assert "_plan_cache" not in loaded.__dict__
    assert [type(s) for s in loaded.stages] == [type(s) for s in pm.stages]
    assert loaded.stages[0].ops == pm.stages[0].ops
    assert loaded.stages[2].model.module is not bundles[1].module
    after = loaded.transform(table)
    for col in ("features", "scores"):
        np.testing.assert_array_equal(vectors(after[col]),
                                      vectors(before[col]))
    unfitted = Pipeline([PORT.IT().resize(6, 5), PORT.Unroll()])
    unfitted.save(str(tmp_path / "p"))
    again = Pipeline.load(str(tmp_path / "p")).fit(table).transform(table)
    np.testing.assert_array_equal(
        vectors(again["features"]),
        vectors(unfitted.fit(table).transform(table)["features"]))
