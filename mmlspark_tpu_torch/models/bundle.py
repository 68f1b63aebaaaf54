"""ModelBundle — a runnable model: an ``nn.Module`` plus its IO contract.

The port of ``mmlspark_tpu/models/bundle.py``. The JAX bundle pairs a
stateless flax module with a separate param tree; a torch module holds
its own parameters, so the bundle here carries the module, the
per-example input shape, the selectable output nodes, the named
preprocessing and a name.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass
class ModelBundle:
    """A runnable model: ``nn.Module`` (parameters included) + IO contract.

    ``output_names`` enumerates the selectable output nodes in graph
    order; modules accept ``output=<name>`` in ``forward``."""

    module: torch.nn.Module
    input_spec: tuple                # per-example input shape, e.g. (224, 224, 3)
    output_names: tuple = ("logits",)
    preprocess: str | None = None    # a key of PREPROCESSORS
    name: str = "model"

    def resolve_output(self, node: str | int | None) -> str:
        """Resolve an output-node selector (name, index, or None=last)."""
        if node is None:
            return self.output_names[-1]
        if isinstance(node, int):
            if not 0 <= node < len(self.output_names):
                raise ValueError(
                    f"output node index {node} out of range; model has "
                    f"{len(self.output_names)} outputs: {self.output_names}")
            return self.output_names[node]
        if node not in self.output_names:
            raise ValueError(
                f"unknown output node {node!r}; available: {self.output_names}")
        return node


def meta_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are empty tensors
    on the meta device: its architecture without its weights, made
    without copying or touching them."""
    memo: dict = {id(t): torch.nn.Parameter(
        torch.empty_like(t, device="meta"), requires_grad=t.requires_grad)
        for t in module.parameters()}
    memo.update({id(t): torch.empty_like(t, device="meta")
                 for t in module.buffers()})
    return copy.deepcopy(module, memo)


# named preprocessing on float tensors, applied on the device before the
# module's forward
PREPROCESSORS: dict[str, Callable[[Any], Any]] = {}


def register_preprocess(name: str):
    def deco(fn):
        PREPROCESSORS[name] = fn
        return fn
    return deco


@register_preprocess("center_128")
def _center_128(x):
    # CIFAR CNTK models center pixels around 0 by subtracting the mean
    # image; a constant 128 shift is the stand-in notebook 301's pipeline
    # uses
    return x - 128.0


@register_preprocess("imagenet_norm")
def _imagenet_norm(x):
    # standard ImageNet channel statistics on 0-255 RGB input
    mean = torch.tensor([123.675, 116.28, 103.53], dtype=x.dtype,
                        device=x.device)
    std = torch.tensor([58.395, 57.12, 57.375], dtype=x.dtype,
                       device=x.device)
    return (x - mean) / std


@register_preprocess("scale_pm1")
def _scale_pm1(x):
    # 0-255 -> [-1, 1] (the ViT checkpoint-family convention)
    return x / 127.5 - 1.0
