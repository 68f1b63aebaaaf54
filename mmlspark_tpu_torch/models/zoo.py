"""Built-in model architectures (the port of ``mmlspark_tpu.models.zoo``).

Entries build the module directly on the target device and fill its
weights from a seed through a ``torch.Generator`` on that device. The
same seed gives other numbers than the JAX zoo's (another generator):
parity with the JAX package goes through ``models/convert.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.convnet import ConvNetCifar, init_convnet_
from mmlspark_tpu_torch.models.resnet import (
    ResNet,
    init_resnet_,
    resnet18_thin,
    resnet50,
)
from mmlspark_tpu_torch.models.vit import ViT, init_vit_, vit_b16, vit_tiny

ZOO: dict[str, Callable[..., ModelBundle]] = {}


def register_model(name: str):
    def deco(fn):
        ZOO[name] = fn
        return fn
    return deco


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _seeded(module: ViT, seed: int, device: torch.device) -> ViT:
    return init_vit_(module, _generator(seed, device)).eval()


@register_model("ViT_B16")
def vit_b16_bundle(num_classes: int = 1000, input_size: int = 224,
                   seed: int = 0, device: Any = None, **kw) -> ModelBundle:
    """ViT-B/16 at full width (BASELINE config 5), bf16 compute."""
    dev = resolve_device(device)
    module = vit_b16(num_classes=num_classes, image_size=input_size,
                     device=dev, **kw)
    return ModelBundle(_seeded(module, seed, dev),
                       (input_size, input_size, 3), ViT.OUTPUT_NAMES,
                       preprocess="scale_pm1", name="ViT_B16")


@register_model("ViT_Tiny")
def vit_tiny_bundle(num_classes: int = 10, input_size: int = 32,
                    seed: int = 0, device: Any = None, **kw) -> ModelBundle:
    dev = resolve_device(device)
    module = vit_tiny(num_classes=num_classes, image_size=input_size,
                      device=dev, **kw)
    return ModelBundle(_seeded(module, seed, dev),
                       (input_size, input_size, 3), ViT.OUTPUT_NAMES,
                       preprocess="scale_pm1", name="ViT_Tiny")


@register_model("ResNet50")
def resnet50_bundle(num_classes: int = 1000, input_size: int = 224,
                    seed: int = 0, device: Any = None,
                    gn_impl: str = "auto", **kw) -> ModelBundle:
    """ResNet-50 with GroupNorm(32) at full width (BASELINE config 3
    backbone, the JAX zoo's training variant), bf16 compute, f32 master
    weights."""
    dev = resolve_device(device)
    module = resnet50(num_classes=num_classes, gn_impl=gn_impl, device=dev,
                      **kw)
    init_resnet_(module, _generator(seed, dev))
    return ModelBundle(module, (input_size, input_size, 3),
                       ResNet.OUTPUT_NAMES, preprocess="imagenet_norm",
                       name="ResNet50")


@register_model("ResNet_Small")
def resnet_small_bundle(num_classes: int = 10, input_size: int = 32,
                        seed: int = 0, device: Any = None,
                        gn_impl: str = "auto", **kw) -> ModelBundle:
    """The same ResNet family at test scale (``resnet18_thin``)."""
    dev = resolve_device(device)
    module = resnet18_thin(num_classes=num_classes, gn_impl=gn_impl,
                           device=dev, **kw)
    init_resnet_(module, _generator(seed, dev))
    return ModelBundle(module, (input_size, input_size, 3),
                       ResNet.OUTPUT_NAMES, preprocess="imagenet_norm",
                       name="ResNet_Small")


@register_model("ConvNet_CIFAR10")
def conv_net_cifar_bundle(num_classes: int = 10, seed: int = 0,
                          device: Any = None, **kw) -> ModelBundle:
    """The CIFAR-10 ConvNet (the repo's headline workload) at full width
    by default (widths (128, 256, 512), dense 512), bf16 compute, f32
    master weights; ``kw`` takes ``widths``, ``dense_width`` and ``dtype``."""
    dev = resolve_device(device)
    module = ConvNetCifar(num_classes=num_classes, device=dev, **kw)
    init_convnet_(module, _generator(seed, dev))
    return ModelBundle(module, ConvNetCifar.INPUT_SPEC,
                       ConvNetCifar.OUTPUT_NAMES,
                       preprocess="center_128", name="ConvNet_CIFAR10")


def get_model(name: str, **kwargs: Any) -> ModelBundle:
    if name not in ZOO:
        raise KeyError(f"unknown zoo model {name!r}; available: {sorted(ZOO)}")
    return ZOO[name](**kwargs)
