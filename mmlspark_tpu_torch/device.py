"""Device choice and the float32 precision policy of the port.

Every entry point of the port runs on ``cuda`` unless its caller asks for
the CPU with ``device="cpu"``. Without a card and without that request it
raises: the port never carries on quietly on the CPU.

Precision policy, set by :func:`resolve_device`: float32 matrix products
and convolutions run in full float32, not TF32
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``). TF32 keeps about three
decimal digits; the JAX reference computes float32 in float32, so the
f32 parity the tests pin holds on the card too. bfloat16 compute is a
model's own choice (``dtype``), never a side effect of this flag.
"""

from __future__ import annotations

import torch

ALLOW_TF32 = False


def apply_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; the CPU only when asked for. Raises when CUDA
    is asked for, explicitly or by default, and there is none."""
    apply_precision_policy()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmlspark_tpu_torch runs on CUDA and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
