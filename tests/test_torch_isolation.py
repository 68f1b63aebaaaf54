"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package, and it never runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mmlspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_source_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_serving_on_cpu_loads_no_jax_module():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from mmlspark_tpu_torch.data.table import DataTable
        from mmlspark_tpu_torch.models.zoo import get_model
        from mmlspark_tpu_torch.serve.config import ServeConfig
        from mmlspark_tpu_torch.serve.server import ModelServer
        bundle = get_model("ViT_Tiny", device="cpu")
        image = np.zeros((32, 32, 3), np.uint8)
        with ModelServer(ServeConfig(buckets=(1, 2))) as server:
            server.add_model("vit", bundle, device="cpu")
            out = server.predict("vit", DataTable({"input": [image] * 2}))
        assert len(out["scores"]) == 2
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_training_on_cpu_loads_no_jax_module():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from mmlspark_tpu_torch.models.zoo import get_model
        from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig
        from mmlspark_tpu_torch.train.preprocess import DevicePreprocess
        module = get_model("ResNet_Small", device="cpu").module
        cfg = TrainConfig(batch_size=4, optimizer="momentum", log_every=1,
                          device="cpu",
                          preprocess=DevicePreprocess(
                              src_crop=(36, 36), resize=(32, 32),
                              flip_lr=True))
        x = np.zeros((6, 40, 40, 3), np.uint8)
        trainer = Trainer(module, cfg).fit_arrays(x, np.zeros(6, np.int64))
        assert len(trainer.history) == 2
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_cifar_train_score_and_evaluate_on_cpu_load_no_jax_module():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from mmlspark_tpu_torch.data.table import DataTable
        from mmlspark_tpu_torch.ml.metrics import confusion_matrix
        from mmlspark_tpu_torch.models.torch_model import TorchModel
        from mmlspark_tpu_torch.models.zoo import get_model
        from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig
        from mmlspark_tpu_torch.train.preprocess import DevicePreprocess
        bundle = get_model("ConvNet_CIFAR10", device="cpu", widths=(4, 8),
                           dense_width=16)
        cfg = TrainConfig(batch_size=4, optimizer="momentum", log_every=1,
                          device="cpu",
                          preprocess=DevicePreprocess(
                              crop_pad=4, flip_lr=True, brightness=0.1,
                              contrast=(0.9, 1.1)))
        x = np.zeros((6, 32, 32, 3), np.uint8)
        y = np.zeros(6, np.int64)
        trainer = Trainer(bundle.module, cfg).fit_arrays(x, y)
        assert len(trainer.history) == 2
        model = TorchModel(model=bundle, input_col="image",
                           output_col="scores", device="cpu")
        out = model.transform(DataTable({"image": list(x.reshape(6, -1))}))
        pred = np.stack(out["scores"]).argmax(-1)
        assert confusion_matrix(y, pred, 10).sum() == 6
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_generation_on_cpu_loads_no_jax_module():
    script = textwrap.dedent("""
        import sys
        import torch
        from mmlspark_tpu_torch.models.sequence import (
            TransformerTagger, init_sequence_)
        from mmlspark_tpu_torch.serve.config import GenerateConfig
        from mmlspark_tpu_torch.serve.server import Client, ModelServer
        model = TransformerTagger(vocab_size=50, embed_dim=16, num_heads=2,
                                  num_layers=1, mlp_dim=32, num_tags=50,
                                  max_len=32, causal=True, device="cpu")
        init_sequence_(model, torch.Generator().manual_seed(0))
        cfg = GenerateConfig(slots=2, t_max=16, prefill_buckets=(4, 8),
                             prefill_rows=2, max_new_tokens=3)
        with ModelServer() as server:
            server.add_generator("lm", model, config=cfg, device="cpu")
            out = Client(server).generate("lm", [1, 2, 3])
            assert out == server.generate_oneshot("lm", [1, 2, 3])
        assert len(out) == 3
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sequence_parallel_training_on_cpu_loads_no_jax_module():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from mmlspark_tpu_torch.models.sequence import (
            TransformerTagger, init_sequence_, pad_sequences)
        from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig
        model = TransformerTagger(vocab_size=50, embed_dim=16, num_heads=2,
                                  num_layers=1, mlp_dim=32, num_tags=50,
                                  max_len=16, causal=True, pad_token_id=0,
                                  device="cpu")
        init_sequence_(model, torch.Generator().manual_seed(0))
        x, _ = pad_sequences([[1, 2, 3], [4, 5, 6, 7, 8, 9]], 16)
        y = np.roll(x, -1, axis=1)
        cfg = TrainConfig(mesh_spec={"sp": 4}, batch_size=2, log_every=1,
                          device="cpu")
        trainer = Trainer(model, cfg).fit_arrays(x, y)
        assert len(trainer.history) == 1
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sequence_parallel_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mmlspark_tpu_torch.ops.attention import attention_block_update
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"sp": 4})
    assert make_mesh({"sp": 4}, "cpu").size == 4
    q = torch.zeros(1, 1, 4, 8)
    keep = torch.ones(1, 4, 4, dtype=torch.bool)
    m = torch.zeros(1, 1, 4, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_block_update(q, q, q, keep, m, m, q, 0.5, impl="cuda")


def test_generation_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mmlspark_tpu_torch.models.sequence import TransformerTagger
    from mmlspark_tpu_torch.ops.attention import decode_attention
    from mmlspark_tpu_torch.serve.server import ModelServer

    model = TransformerTagger(vocab_size=50, embed_dim=16, num_heads=2,
                              num_layers=1, mlp_dim=32, num_tags=50,
                              max_len=128, causal=True, device="cpu")
    with ModelServer() as server:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server.add_generator("lm", model)
        assert server.generators() == []
    q = torch.zeros(2, 2, 8)
    kv = torch.zeros(2, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention(q, kv, kv, impl="cuda")


def test_training_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mmlspark_tpu_torch.models.resnet import resnet18_thin, resnet50
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops.group_norm import group_norm
    from mmlspark_tpu_torch.ops.resize import fused_resize_norm
    from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig

    for name in ("ResNet50", "ResNet_Small"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50()
    module = get_model("ResNet_Small", device="cpu").module
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(module, TrainConfig())
    assert Trainer(module, TrainConfig(device="cpu")).device.type == "cpu"
    # a kernel asked for on CPU tensors raises; the default takes the plain
    # version only because the tensors lie on the CPU
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        group_norm(x, torch.ones(8), torch.zeros(8), 4, impl="cuda")
    img = torch.zeros(1, 8, 8, 3, dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_resize_norm(img, z, z, (6, 6), (4, 4), 1.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        resnet18_thin(gn_impl="cuda", device="cpu")(torch.zeros(1, 8, 8, 3))


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.vit import vit_tiny
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.serve.server import ModelServer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("ViT_Tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit_tiny()
    bundle = get_model("ViT_Tiny", device="cpu")
    table = DataTable({"input": [np.zeros((32, 32, 3), np.uint8)]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchModel(model=bundle).transform(table)
    with ModelServer() as server:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server.add_model("vit", bundle)
        assert server.models() == []
    assert resolve_device("cpu") == torch.device("cpu")


def test_pipeline_featurize_and_save_on_cpu_load_no_jax_module():
    script = textwrap.dedent("""
        import sys, tempfile
        import numpy as np
        from mmlspark_tpu_torch.core import plan
        from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel
        from mmlspark_tpu_torch.core.schema import make_image
        from mmlspark_tpu_torch.data.table import DataTable
        from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
        from mmlspark_tpu_torch.stages.image import (
            ImageTransformer, UnrollImage)
        images = np.zeros((3, 40, 48, 3), np.uint8)
        table = DataTable({"image": [make_image("p", a) for a in images]})
        f = ImageFeaturizer(device="cpu").set_model_by_name("ResNet_Small")
        model = Pipeline([ImageTransformer(device="cpu").crop(4, 4, 32, 32),
                          f]).fit(table)
        assert [k for k, _ in plan.describe_plan(model.stages, table)] == [
            "device"]
        out = model.transform(table)
        unrolled = PipelineModel([ImageTransformer(device="cpu").flip(1),
                                  UnrollImage()]).transform(table)
        with tempfile.TemporaryDirectory() as d:
            model.save(d + "/m")
            again = PipelineModel.load(d + "/m").transform(table)
        assert np.array_equal(np.stack(out["features"]),
                              np.stack(again["features"]))
        assert len(unrolled["features"][0]) == 40 * 48 * 3
        roots = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
        print(sorted(m for m in sys.modules
                     if any(m == r or m.startswith(r + ".") for r in roots)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_pipeline_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.core.schema import make_image
    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.stages.image import ImageTransformer, UnrollImage

    table = DataTable({"image": [make_image("p", np.zeros((8, 8, 3)))] * 2})
    # a fused segment runs on the card unless a stage asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineModel([ImageTransformer().flip(1),
                       UnrollImage()]).transform(table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageFeaturizer().set_model_by_name("ResNet_Small")
    # host stages alone never touch a device
    assert len(ImageTransformer().flip(1).transform(table)) == 2
    out = PipelineModel([ImageTransformer().flip(1),
                         UnrollImage(device="cpu")]).transform(table)
    assert len(out["features"][0]) == 8 * 8 * 3
