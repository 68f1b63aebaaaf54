"""Stage persistence (the port of ``mmlspark_tpu/core/serialize.py``
``save_stage``/``load_stage``).

A stage saves to a directory: ``metadata.json`` holds the class path, the
uid and the JSON-representable params; each *complex* param (a model
bundle, nested stages, an array) is written under ``complex/<name>/`` by
the writer its type selects:

* a stage, or a list of stages: saved recursively;
* a :class:`~mmlspark_tpu_torch.models.bundle.ModelBundle`: its weights
  through ``torch.save`` of the module's ``state_dict`` (on the CPU), its
  architecture as the module with every parameter and buffer on the meta
  device (no weights), and its IO contract as JSON;
* a numpy array through ``np.save``; anything else by pickle (the same
  trust model as the JAX package's).

The planner's caches live in ``__dict__`` entries that are not params, so
they are never written.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
from typing import Any

import numpy as np
import torch

_FORMAT_VERSION = 1


def _json_default(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON-serializable: {type(v)}")


def class_path(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def load_class(path: str) -> type:
    module, _, name = path.rpartition(".")
    obj: Any = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _save_bundle(bundle: Any, directory: str) -> None:
    from mmlspark_tpu_torch.models.bundle import meta_copy
    module = bundle.module
    torch.save({k: v.detach().cpu() for k, v in
                module.state_dict().items()},
               os.path.join(directory, "weights.pt"))
    torch.save(meta_copy(module), os.path.join(directory, "module.pt"))
    with open(os.path.join(directory, "bundle.json"), "w") as f:
        json.dump({"input_spec": list(bundle.input_spec),
                   "output_names": list(bundle.output_names),
                   "preprocess": bundle.preprocess, "name": bundle.name}, f)


def _load_bundle(directory: str) -> Any:
    from mmlspark_tpu_torch.models.bundle import ModelBundle
    module = torch.load(os.path.join(directory, "module.pt"),
                        weights_only=False)
    module = module.to_empty(device="cpu")
    module.load_state_dict(torch.load(os.path.join(directory, "weights.pt"),
                                      weights_only=True))
    with open(os.path.join(directory, "bundle.json")) as f:
        info = json.load(f)
    return ModelBundle(module.eval(), tuple(info["input_spec"]),
                       tuple(info["output_names"]),
                       preprocess=info["preprocess"], name=info["name"])


def save_value(value: Any, directory: str) -> None:
    """Write one complex value into ``directory`` with a ``kind`` tag."""
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.models.bundle import ModelBundle

    os.makedirs(directory, exist_ok=True)

    def tag(kind: str, extra: dict | None = None) -> None:
        with open(os.path.join(directory, "kind.json"), "w") as f:
            json.dump({"kind": kind, **(extra or {})}, f)

    if isinstance(value, PipelineStage):
        tag("stage")
        value.save(os.path.join(directory, "stage"))
    elif isinstance(value, (list, tuple)) and value and all(
            isinstance(s, PipelineStage) for s in value):
        tag("stage_list", {"n": len(value),
                           "tuple": isinstance(value, tuple)})
        for i, s in enumerate(value):
            s.save(os.path.join(directory, f"stage_{i}"))
    elif isinstance(value, ModelBundle):
        tag("bundle")
        _save_bundle(value, directory)
    elif isinstance(value, np.ndarray):
        tag("ndarray")
        np.save(os.path.join(directory, "value.npy"), value,
                allow_pickle=value.dtype == object)
    else:
        tag("pickle")
        with open(os.path.join(directory, "value.pkl"), "wb") as f:
            pickle.dump(value, f)


def load_value(directory: str) -> Any:
    with open(os.path.join(directory, "kind.json")) as f:
        info = json.load(f)
    kind = info["kind"]
    if kind == "stage":
        return load_stage(os.path.join(directory, "stage"))
    if kind == "stage_list":
        out = [load_stage(os.path.join(directory, f"stage_{i}"))
               for i in range(info["n"])]
        return tuple(out) if info.get("tuple") else out
    if kind == "bundle":
        return _load_bundle(directory)
    if kind == "ndarray":
        return np.load(os.path.join(directory, "value.npy"),
                       allow_pickle=True)
    if kind == "pickle":
        with open(os.path.join(directory, "value.pkl"), "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown serialized kind {kind!r} in {directory}")


def save_stage(stage: Any, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    meta = {"format_version": _FORMAT_VERSION,
            "class": class_path(type(stage)),
            "params": stage._simple_param_values(),
            "uid": stage.uid}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, default=_json_default, indent=1)
    for name, value in stage._complex_param_values().items():
        save_value(value, os.path.join(path, "complex", name))


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = load_class(meta["class"])
    stage = cls.__new__(cls)
    stage._values = {}
    stage._uid = meta.get("uid")
    stage._post_init()
    declared = cls.params()
    # JSON gives lists back for tuples; params validate on set
    stage.set(**{k: v for k, v in meta["params"].items() if k in declared})
    cdir = os.path.join(path, "complex")
    if os.path.isdir(cdir):
        for name in os.listdir(cdir):
            if name in declared:
                stage._values[name] = load_value(os.path.join(cdir, name))
    return stage
