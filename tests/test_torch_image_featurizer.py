"""The port's ImageFeaturizer against the JAX package's, on the CPU.

The JAX ``ResNet_Small`` bundle (float32, GroupNorm through its XLA
reference) is converted by ``models/convert.py``
``resnet_state_dict_from_flax`` into the port's ``resnet18_thin``; the
same numpy-seeded uint8 BGR images go through both ``ImageFeaturizer``s.

Tolerances: features ``rtol=atol=1e-5`` (``tests/test_torch_resnet.py``'s
``F32_TOL``: both sides float32, differing in summation order), compared
over the same input pixels; resized image columns within one count (the
two round ``v + 0.5`` of a float32 blend that one side's compiler may
contract into FMAs).
"""

import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core import plan as jax_plan  # noqa: E402
from mmlspark_tpu.core.pipeline import (  # noqa: E402
    PipelineModel as JaxPipelineModel,
)
from mmlspark_tpu.core.schema import make_image as jax_make_image  # noqa: E402
from mmlspark_tpu.data.table import DataTable as JaxTable  # noqa: E402
from mmlspark_tpu.models.image_featurizer import (  # noqa: E402
    ImageFeaturizer as JaxImageFeaturizer,
)
from mmlspark_tpu.models import resnet as jres  # noqa: E402
from mmlspark_tpu.models.bundle import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu.stages.image import (  # noqa: E402
    ImageTransformer as JaxImageTransformer,
)

from mmlspark_tpu_torch.core import plan  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import (  # noqa: E402
    Pipeline, PipelineModel,
)
from mmlspark_tpu_torch.core.schema import make_image  # noqa: E402
from mmlspark_tpu_torch.core.stage import ArrayMeta  # noqa: E402
from mmlspark_tpu_torch.data.table import DataTable  # noqa: E402
from mmlspark_tpu_torch.models.bundle import ModelBundle  # noqa: E402
from mmlspark_tpu_torch.models.convert import (  # noqa: E402
    resnet_state_dict_from_flax,
)
from mmlspark_tpu_torch.models.image_featurizer import (  # noqa: E402
    ImageFeaturizer,
)
from mmlspark_tpu_torch.models.resnet import ResNet, resnet18_thin  # noqa: E402
from mmlspark_tpu_torch.stages.image import ImageTransformer  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bundles():
    # the zoo entry's module and params, initialised under one jax.jit
    # (flax's eager init compiles op by op, for seconds, on the CPU)
    jm = jres.resnet18_thin(num_classes=10, dtype=jnp.float32,
                            gn_impl="xla")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    jb = JaxBundle(module=jm, params=params, input_spec=(32, 32, 3),
                   output_names=jres.ResNet.OUTPUT_NAMES,
                   preprocess="imagenet_norm", name="ResNet_Small")
    module = resnet18_thin(num_classes=10, dtype=torch.float32,
                           device="cpu")
    module.load_state_dict(resnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jb.params)))
    return jb, ModelBundle(module.eval(), (32, 32, 3), ResNet.OUTPUT_NAMES,
                           preprocess="imagenet_norm", name="ResNet_Small")


def _tables(n, h, w, seed=0):
    r = np.random.default_rng(seed)
    pixels = r.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    return (JaxTable({"image": [jax_make_image(f"p{k}", p)
                                for k, p in enumerate(pixels)]}),
            DataTable({"image": [make_image(f"p{k}", p)
                                 for k, p in enumerate(pixels)]}))


def _featurizers(bundles, cut, **kw):
    jf = JaxImageFeaturizer(cut_output_layers=cut, **kw)
    jf.set(model=bundles[0])
    return jf, ImageFeaturizer(cut_output_layers=cut, device="cpu",
                               model=bundles[1], **kw)


def _stack(col):
    return np.stack(list(col))


@pytest.mark.parametrize("cut", [0, 1])
def test_features_match_jax(bundles, cut):
    """Images at the model's size (the resize is the identity on both
    sides), 7 rows at minibatch 4: a full minibatch and a padded tail."""
    jt, pt = _tables(7, 32, 32)
    jf, pf = _featurizers(bundles, cut, minibatch_size=4)
    want = _stack(jf.transform(jt)["features"])
    with plan.count_crossings() as c:
        got = pf.transform(pt)
    assert c.uploads == 2 and c.fetches == 2
    width = 10 if cut == 0 else bundles[1].module.head.in_features
    assert _stack(got["features"]).shape == want.shape == (7, width)
    np.testing.assert_allclose(_stack(got["features"]), want, **F32_TOL)
    np.testing.assert_array_equal(
        _stack(v["data"] for v in got["image"]),
        _stack(v["data"] for v in pt["image"]))


def test_resized_image_column_matches_jax(bundles):
    jt, pt = _tables(5, 40, 48, seed=1)
    jf, pf = _featurizers(bundles, 1)
    want, got = jf.transform(jt), pf.transform(pt)
    assert got.columns == want.columns == ["image", "features"]
    gap = np.abs(_stack(v["data"] for v in got["image"]).astype(int)
                 - _stack(v["data"] for v in want["image"]).astype(int))
    assert gap.max() <= 1
    assert got["image"][3]["path"] == "p3" and got.meta["image"]["is_image"]
    # the port's features over its own resized images equal the ones a
    # second featurizer computes from that column (the resize then is the
    # identity)
    again = pf.transform(DataTable({"image": list(got["image"])}))
    np.testing.assert_array_equal(_stack(again["features"]),
                                  _stack(got["features"]))


def test_fuses_inside_a_pipeline_as_jax_does(bundles):
    """Crop + flip to the model's size, then the featurizer: one segment of
    both stages on both sides, one upload a minibatch; features equal to
    the JAX pipeline's."""
    jt, pt = _tables(6, 40, 48, seed=2)
    jf, pf = _featurizers(bundles, 1, minibatch_size=4)
    jstages = [JaxImageTransformer().crop(4, 6, 32, 32).flip(1), jf]
    stages = [ImageTransformer(device="cpu").crop(4, 6, 32, 32).flip(1), pf]
    assert [(k, len(s)) for k, s in plan.describe_plan(stages, pt)] == \
        [(k, len(s)) for k, s in jax_plan.describe_plan(jstages, jt)] == \
        [("device", 2)]
    want = JaxPipelineModel(jstages).transform(jt)
    with plan.count_crossings() as c:
        got = Pipeline(stages).fit(pt).transform(pt)
    assert c.uploads == 2 and c.upload_shapes == {(4, 40, 48, 3)}
    np.testing.assert_array_equal(_stack(v["data"] for v in got["image"]),
                                  _stack(v["data"] for v in want["image"]))
    np.testing.assert_allclose(_stack(got["features"]),
                               _stack(want["features"]), **F32_TOL)


def test_declines_a_resize_that_changes_the_image(bundles):
    """An image not at the model's size: the featurizer's own transform
    writes the resized column, so it does not fuse with its neighbour (as
    in JAX) and runs its own segment."""
    jt, pt = _tables(3, 40, 48)
    jf, pf = _featurizers(bundles, 1)
    assert pf.device_fn(ArrayMeta((40, 48, 3), "uint8", True)) is None
    jstages = [JaxImageTransformer().flip(1), jf]
    stages = [ImageTransformer(device="cpu").flip(1), pf]
    assert [(k, len(s)) for k, s in plan.describe_plan(stages, pt)] == \
        [(k, len(s)) for k, s in jax_plan.describe_plan(jstages, jt)] == \
        [("host", 1), ("host", 1)]
    with plan.count_crossings() as c:
        PipelineModel(stages).transform(pt)
    assert c.uploads == 1  # the featurizer's own resize → forward segment


def test_save_load_and_pickle_give_the_same_features(bundles, tmp_path):
    _, pt = _tables(4, 32, 32, seed=3)
    pf = _featurizers(bundles, 1)[1]
    before = _stack(pf.transform(pt)["features"])
    assert "_stage_cache" in pf.__dict__ and "_plan_cache" in pf.__dict__
    pf.save(str(tmp_path / "f"))
    loaded = ImageFeaturizer.load(str(tmp_path / "f"))
    assert loaded.model.module is not pf.model.module
    assert loaded.cut_output_layers == 1 and loaded.device == "cpu"
    np.testing.assert_array_equal(_stack(loaded.transform(pt)["features"]),
                                  before)
    clone = pickle.loads(pickle.dumps(pf))
    assert "_plan_cache" not in clone.__dict__
    np.testing.assert_array_equal(_stack(clone.transform(pt)["features"]),
                                  before)


def test_model_by_name_cut_and_cache():
    f = ImageFeaturizer(device="cpu").set_model_by_name("ResNet_Small")
    assert next(f.model.module.parameters()).device.type == "cpu"
    _, pt = _tables(2, 20, 20)
    out = f.transform(pt)
    assert _stack(out["features"]).shape == (
        2, f.model.module.head.in_features)
    first = f._stages()
    assert f._stages() is first
    f.set(cut_output_layers=0)
    assert f._stages() is not first
    assert _stack(f.transform(pt)["features"]).shape == (2, 10)
    f.set(cut_output_layers=2)
    with pytest.raises(ValueError, match="only 2 output nodes"):
        f.transform(pt)


def _ragged_tables(sizes, seed=4):
    r = np.random.default_rng(seed)
    pixels = [r.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in sizes]
    return (JaxTable({"image": [jax_make_image(f"r{k}", p)
                                for k, p in enumerate(pixels)]}),
            DataTable({"image": [make_image(f"r{k}", p)
                                 for k, p in enumerate(pixels)]}))


def test_ragged_images_match_jax(bundles):
    """Images of mixed sizes: the planner declines the fused segment on
    both sides, the resize runs on the host and the model alone over the
    resized image column. Images within one count of JAX's; features
    against the JAX featurizer over the port's resized images (the same
    pixels), within ``F32_TOL``."""
    jt, pt = _ragged_tables([(40, 48), (27, 35), (32, 32), (50, 20)])
    jf, pf = _featurizers(bundles, 1, minibatch_size=3)
    want = jf.transform(jt)
    with plan.count_crossings() as c:
        got = pf.transform(pt)
    assert c.uploads == 2  # the model alone: 4 rows at minibatch 3
    assert got.columns == want.columns == ["image", "features"]
    images = _stack(v["data"] for v in got["image"])
    gap = np.abs(images.astype(int)
                 - _stack(v["data"] for v in want["image"]).astype(int))
    assert images.shape == (4, 32, 32, 3) and gap.max() <= 1
    same = jf.transform(JaxTable({"image": [
        jax_make_image(f"r{k}", im) for k, im in enumerate(images)]}))
    np.testing.assert_allclose(_stack(got["features"]),
                               _stack(same["features"]), **F32_TOL)


@pytest.mark.parametrize("rows", ["uint8", "one_float_row"])
def test_torch_model_over_an_image_column_matches_jax(bundles, rows):
    """TorchModel alone on an image-struct column, as the featurizer's
    host fallback runs it: uint8 rows go through the planner's coercion;
    a float32 row makes the whole batch float32 on both sides (no row is
    truncated into uint8)."""
    from mmlspark_tpu.models.jax_model import JaxModel
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    pixels = list(np.random.default_rng(6).integers(
        0, 256, (5, 32, 32, 3), dtype=np.uint8))
    if rows == "one_float_row":
        pixels[2] = pixels[2].astype(np.float32) + 0.25
    jt = JaxTable({"image": [jax_make_image(f"p{k}", p)
                             for k, p in enumerate(pixels)]})
    pt = DataTable({"image": [make_image(f"p{k}", p)
                              for k, p in enumerate(pixels)]})
    jm = JaxModel(input_col="image", output_col="out", output_node="features",
                  minibatch_size=2)
    jm.set(model=bundles[0])
    tm = TorchModel(input_col="image", output_col="out", output_node="features",
                    minibatch_size=2, device="cpu", model=bundles[1])
    np.testing.assert_allclose(_stack(tm.transform(pt)["out"]),
                               _stack(jm.transform(jt)["out"]), **F32_TOL)


def test_device_fn_traces_a_bundle_that_asks_for_the_kernel():
    """A bundle built with ``gn_impl="cuda"`` (the kernel route, which
    raises on CPU tensors) still has a device op: the meta-device trace
    takes the plain GroupNorm, so the featurizer fuses and serving keeps
    its asynchronous dispatch."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_model
    b = get_model("ResNet_Small", gn_impl="cuda", device="cpu")
    meta = ArrayMeta((32, 32, 3), "uint8", True)
    op = TorchModel(model=b, output_node="features", device="cpu").device_fn(meta)
    assert op is not None
    assert op.out_meta == ArrayMeta((b.module.head.in_features,), "float32")
    f = ImageFeaturizer(device="cpu", model=b)
    assert f.device_fn(meta).out_meta == op.out_meta
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        f.transform(_tables(1, 32, 32)[1])


@pytest.mark.parametrize("op", ["group_norm", "attention", "resize"])
def test_meta_tensors_take_the_plain_route(op):
    """Every kernel wrapper's route resolver: a meta tensor (a shape
    trace) takes the plain version even where ``cuda`` is asked for; a
    CPU tensor with ``cuda`` still raises."""
    import importlib
    resolve = importlib.import_module(
        f"mmlspark_tpu_torch.ops.{op}").resolve_impl
    for impl in ("auto", "cuda", "torch"):
        assert resolve(impl, torch.empty(2, device="meta")) == "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resolve("cuda", torch.empty(2))
