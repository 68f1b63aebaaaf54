"""Mesh axes and the mesh of virtual ranks on one card.

The port of ``mmlspark_tpu/parallel/mesh.py`` as far as sequence-parallel
training needs it: the canonical axis vocabulary, :class:`MeshSpec` and its
``resolve`` (copied), and :func:`make_mesh`.

The JAX package's mesh is a grid of devices, and its collectives run
between them. Here every rank of the mesh is a *virtual* rank on one card:
the mesh holds the axis sizes and the one ``torch.device`` that all ranks
live on, and a sharded operation carries the ranks as a leading tensor axis
(:func:`mmlspark_tpu_torch.parallel.ring_attention.ring_attention` runs its
``sp`` ranks as one rank-major batch and turns the ring's collective-permute
into a rotation of that axis). A mesh over several distinct cards (one
process per card, NCCL) is not ported: :func:`make_mesh` raises
``NotImplementedError`` when given a list of devices (ROADMAP A2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from mmlspark_tpu_torch.device import resolve_device

# the canonical axis vocabulary, in order
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout; -1 on ``dp`` means "all remaining"."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = math.prod(v for v in sizes.values() if v != -1)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {free}")
        if free:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[free[0]] = n_devices // fixed
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"mesh {sizes} covers {total} devices, have {n_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, in :data:`AXES` order, like a JAX mesh's) and
    the one device that every virtual rank lives on."""

    shape: Mapping[str, int]
    device: torch.device

    @property
    def size(self) -> int:
        """The number of virtual ranks: the product of the axes."""
        return math.prod(self.shape.values())


def make_mesh(spec: MeshSpec | Mapping[str, int] | None = None,
              device: Any = None) -> Mesh:
    """A mesh of virtual ranks on one card. ``spec``: a :class:`MeshSpec`,
    its dict form, or None (one rank). A free ``dp=-1`` resolves to 1, so
    the mesh has as many ranks as the product of the fixed axes.
    ``device``: the card (None = cuda, which raises without one; ``"cpu"``
    when asked). A list of devices, as the JAX package's ``make_mesh``
    takes, asks for a mesh over several cards, which raises."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            "a mesh over a list of devices needs the multi-process "
            "transport (one process per card, NCCL), which is not ported "
            "yet (ROADMAP A2); the port runs every rank of a mesh as a "
            "virtual rank on one card: pass that one device")
    if spec is None:
        spec = MeshSpec()
    if isinstance(spec, Mapping):
        spec = MeshSpec(**dict(spec))
    dev = resolve_device(device)
    fixed = math.prod(v for v in dataclasses.asdict(spec).values()
                      if v != -1)
    sizes = spec.resolve(fixed)
    return Mesh(shape={a: sizes[a] for a in AXES}, device=dev)
