"""Weight conversion from the JAX package's ViT, ResNet, ConvNet and
TransformerTagger param trees.

``resnet_state_dict_from_flax(params)`` takes the flax ``ResNet`` params
(``norm="group"``) and returns the ``state_dict`` of
:class:`mmlspark_tpu_torch.models.resnet.ResNet`: conv kernels HWIO
become OIHW, the ``Dense`` head ``[in, out]`` becomes ``Linear.weight
[out, in]``, and GroupNorm ``scale``/``bias`` keep their names.

``vit_state_dict_from_flax(params)`` takes the flax ``ViT`` params (the
``ModelBundle.params`` of ``mmlspark_tpu.models.zoo.ViT_B16``/``ViT_Tiny``)
as nested dicts of numpy arrays and returns the ``state_dict`` of
:class:`mmlspark_tpu_torch.models.vit.ViT`:

* ``Dense`` kernels ``[in, out]`` become ``Linear`` weights ``[out, in]``;
* ``DenseGeneral`` ``query``/``key``/``value`` kernels ``[D, H, dh]`` are
  reshaped to ``[D, H·dh]`` (head-major, as ``view(B, T, H, dh)``
  unflattens it) before the transpose, their biases ``[H, dh]`` to
  ``[H·dh]``; the ``out`` kernel ``[H, dh, D]`` is reshaped to
  ``[H·dh, D]`` before the transpose;
* the patch conv kernel HWIO becomes OIHW;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``.

``convnet_state_dict_from_flax(params)`` takes the flax ``ConvNetCifar``
params (``conv{i}a``, ``conv{i}b``, ``dense0``, ``head``), of either stem,
and returns the ``state_dict`` of
:class:`mmlspark_tpu_torch.models.convnet.ConvNetCifar`: conv kernels
HWIO become OIHW; dense kernels ``[in, out]`` become ``[out, in]``. The
``dense0`` kernel's input axis stays in flax's flatten order, (h, w, C)
over the NHWC activation, which is the order the port flattens in.

``sequence_state_dict_from_flax(params)`` takes the flax
``TransformerTagger`` params (``embed/embedding``, ``pos_embed``, per layer
``ln_a{i}``, ``qkv{i}``, ``proj{i}``, ``ln_b{i}``, ``mlp_in{i}``,
``mlp_out{i}``, then ``ln_f`` and ``head``) and returns the ``state_dict``
of :class:`mmlspark_tpu_torch.models.sequence.TransformerTagger`, whose
layer ``i`` lives under ``blocks.{i}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p: Mapping, prefix: str, out: dict) -> None:
    kernel = np.asarray(p["kernel"], np.float32)
    out[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    out[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _layer_norm(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def vit_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's ViT ``state_dict`` (float32 CPU tensors) from flax params."""
    out: dict[str, torch.Tensor] = {}
    conv = np.asarray(params["patch_embed"]["kernel"], np.float32)
    out["patch_embed.weight"] = _t(conv.transpose(3, 2, 0, 1))
    out["patch_embed.bias"] = _t(params["patch_embed"]["bias"])
    out["pos_embed"] = _t(params["pos_embed"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        p = params[f"block{i}"]
        pre = f"blocks.{i}"
        _layer_norm(p["ln1"], f"{pre}.ln1", out)
        for name in ("query", "key", "value"):
            _dense(p["attn"][name], f"{pre}.attn.{name}", out)
        o_kernel = np.asarray(p["attn"]["out"]["kernel"], np.float32)
        out[f"{pre}.attn.out.weight"] = _t(
            o_kernel.reshape(-1, o_kernel.shape[-1]).T)
        out[f"{pre}.attn.out.bias"] = _t(p["attn"]["out"]["bias"])
        _layer_norm(p["ln2"], f"{pre}.ln2", out)
        _dense(p["mlp_in"], f"{pre}.mlp_in", out)
        _dense(p["mlp_out"], f"{pre}.mlp_out", out)
    _layer_norm(params["ln_f"], "ln_f", out)
    _dense(params["head"], "head", out)
    return out


def _conv(p: Mapping, prefix: str, out: dict) -> None:
    # HWIO → OIHW
    kernel = np.asarray(p["kernel"], np.float32)
    out[f"{prefix}.weight"] = _t(kernel.transpose(3, 2, 0, 1))


def _group_norm(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.scale"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def resnet_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's ResNet ``state_dict`` (float32 CPU tensors) from the
    flax params of a ``norm="group"`` ResNet (either ``gn_impl``: the
    ``gn_*`` names and shapes are the same under both)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["conv_stem"], "conv_stem", out)
    _group_norm(params["gn_stem"], "gn_stem", out)
    for name in sorted(k for k in params if k.startswith("stage")):
        block = params[name]
        for conv, norm in (("conv1", "gn1"), ("conv2", "gn2"),
                           ("conv3", "gn3"), ("proj", "gn_proj")):
            if conv in block:
                _conv(block[conv], f"blocks.{name}.{conv}", out)
                _group_norm(block[norm], f"blocks.{name}.{norm}", out)
    _dense(params["head"], "head", out)
    return out


def convnet_state_dict_from_flax(params: Mapping
                                 ) -> dict[str, torch.Tensor]:
    """The port's ConvNetCifar ``state_dict`` (float32 CPU tensors) from
    flax params. A patch-stem ``PatchConv3x3`` keeps the direct conv's
    names and ``(3, 3, cin, F)`` layout, so both stems convert alike."""
    out: dict[str, torch.Tensor] = {}
    for name in sorted(k for k in params if k.startswith("conv")):
        _conv(params[name], name, out)
        out[f"{name}.bias"] = _t(params[name]["bias"])
    _dense(params["dense0"], "dense0", out)
    _dense(params["head"], "head", out)
    return out


_SEQUENCE_LAYER = {"ln_a": _layer_norm, "qkv": _dense, "proj": _dense,
                   "ln_b": _layer_norm, "mlp_in": _dense, "mlp_out": _dense}


def sequence_state_dict_from_flax(params: Mapping
                                  ) -> dict[str, torch.Tensor]:
    """The port's TransformerTagger ``state_dict`` (float32 CPU tensors)
    from the flax params of the dense (non-MoE) model."""
    out: dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "pos_embed": _t(params["pos_embed"]),
    }
    layers = sum(1 for k in params if k.startswith("qkv"))
    for i in range(layers):
        for name, convert in _SEQUENCE_LAYER.items():
            convert(params[f"{name}{i}"], f"blocks.{i}.{name}", out)
    _layer_norm(params["ln_f"], "ln_f", out)
    _dense(params["head"], "head", out)
    return out
