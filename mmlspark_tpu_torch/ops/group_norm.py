"""GroupNorm(+ReLU) over NHWC: the hand-written CUDA kernel and its plain
PyTorch version.

The port of ``mmlspark_tpu/ops/group_norm.py`` (the Pallas kernel
``_group_norm_fwd_pallas``), the normalisation of every ResNet block.
Same function: per sample, per group of ``C / num_groups`` neighbouring
channels, float32 statistics over ``H·W·C/G`` values with the centred
two-pass variance, ``eps`` 1e-6, then ``(x − μ)·rstd·scale + bias``, an
optional ReLU, and the output in the input's dtype.

* :func:`group_norm_reference` is the plain version, written from the JAX
  package's ``group_norm_reference``. The CPU tests hold it against the
  JAX function; ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`group_norm` dispatches on ``impl``: ``"auto"`` takes the kernel
  for CUDA tensors and the plain version for CPU tensors; ``"cuda"`` and
  ``"torch"`` force one or the other. A CUDA tensor under ``"auto"``
  reaches the kernel or raises; there is no size gate and no fallback.
* The kernel runs the forward only. Its backward recomputes the plain
  version under autograd and differentiates that (the JAX package's
  ``_gn_bwd`` does the same with ``jax.vjp``), so the gradients are the
  plain version's.
* ``launches`` counts calls that reach ``ops/csrc/group_norm.cu``: one per
  ``group_norm`` call, however many CUDA launches the kernel makes.

The kernel takes ``x`` contiguous in NHWC order (an NCHW tensor in
``torch.channels_last`` seen through ``permute(0, 2, 3, 1)`` is that), in
float32 or bfloat16, with float32 ``scale``/``bias`` of ``[C]``; the
wrapper raises on any other layout or dtype rather than copying.
"""

from __future__ import annotations

import ctypes
import threading

import torch

IMPLS = ("auto", "cuda", "torch")
DEFAULT_EPS = 1e-6

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's block width, and the stats blocks it aims for over a batch
# (enough to fill 132 SMs several times over at N=64)
_THREADS = 256
_STATS_BLOCKS = 1024
# the normalise pass gives each block at least this many rows' worth of
# channels, so the per-block table of per-channel constants stays small
# against the elements it serves
_APPLY_ROWS = 8
_APPLY_BLOCKS = 4096
_MAX_ELEMS_PER_SAMPLE = 2 ** 30

# launches of the CUDA kernel; reset by whoever reads it
launches = 0
_count_lock = threading.Lock()


def _validate_groups(c: int, num_groups: int) -> None:
    # channels that match no group would silently normalise to zero;
    # refuse them (the JAX package's _validate_groups)
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(
            f"group_norm: {c} channels not divisible into "
            f"{num_groups} groups")


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = DEFAULT_EPS,
                         relu: bool = False) -> torch.Tensor:
    """Plain PyTorch GroupNorm over the channel (last) axis of NHWC input:
    float32 statistics, centred variance, output in ``x.dtype``."""
    n, h, w, c = x.shape
    _validate_groups(c, num_groups)
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out.reshape(n, h, w, c) * scale + bias
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype)


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` → the kernel for CUDA tensors, the plain version for CPU
    tensors. ``cuda`` on CPU tensors raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown group_norm impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(
            "impl='cuda' runs the CUDA kernel and needs CUDA tensors; "
            f"got tensors on {x.device}")
    return impl


def plan(n: int, hw: int, c: int) -> dict:
    """How the kernel cuts one call: the statistics tiles (rows of H·W per
    tile, tiles per sample), the threads of a statistics block (channel
    threads × row threads) and the normalise blocks per sample."""
    ntiles = max(1, min(hw, -(-_STATS_BLOCKS // n)))
    tile_rows = -(-hw // ntiles)
    ntiles = -(-hw // tile_rows)
    ct = min(c, _THREADS)
    rt = max(1, _THREADS // ct)
    apply_blocks = max(1, min(-(-_APPLY_BLOCKS // n),
                              hw // _APPLY_ROWS))
    return {"ntiles": ntiles, "tile_rows": tile_rows, "ct": ct, "rt": rt,
            "apply_blocks": apply_blocks}


def _kernel_fn():
    """The C entry point of ``ops/csrc/group_norm.cu``, built on first
    use, with every argument typed (pointers and the stream as
    ``c_void_p``)."""
    from mmlspark_tpu_torch.ops import _build
    fn = _build.load("group_norm").group_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(x, scale, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the group_norm kernel "
                        "takes torch.float32 or torch.bfloat16")
    if not x.is_contiguous():
        raise ValueError(
            "the group_norm kernel takes x contiguous in NHWC order (an "
            "NCHW tensor in torch.channels_last, permuted to NHWC); got "
            f"shape {tuple(x.shape)} with strides {x.stride()}")
    c = x.shape[3]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    n, h, w, _ = x.shape
    if h * w * c > _MAX_ELEMS_PER_SAMPLE:
        raise ValueError(f"a sample of {h}x{w}x{c} exceeds the kernel's "
                         f"{_MAX_ELEMS_PER_SAMPLE} elements per sample")


def _group_norm_cuda(x, scale, bias, num_groups: int, eps: float,
                     relu: bool) -> torch.Tensor:
    """Launch the kernel on the current stream; output and scratch are
    allocated here, the kernel allocates nothing."""
    global launches
    _check_cuda_operands(x, scale, bias)
    n, h, w, c = x.shape
    p = plan(n, h * w, c)
    fn = _kernel_fn()
    out = torch.empty_like(x)
    part = torch.empty((n, p["ntiles"], num_groups, 2), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((n, num_groups, 2), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _count_lock:
            launches += 1
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), part.data_ptr(), stats.data_ptr(),
                 _DTYPES[x.dtype], n, h * w, c, num_groups,
                 p["tile_rows"], p["ntiles"], p["ct"], p["rt"],
                 p["apply_blocks"], _THREADS, int(relu), float(eps),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"group_norm kernel launch failed: cudaError {err} "
            f"(x {tuple(x.shape)} {x.dtype}, groups {num_groups})")
    return out


def group_norm_backward(grad_out, x, scale, bias, num_groups: int,
                        eps: float = DEFAULT_EPS, relu: bool = False):
    """The gradients of ``x``, ``scale`` and ``bias``: the plain version
    recomputed under autograd and differentiated, as the JAX package's
    ``_gn_bwd`` does with ``jax.vjp``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, scale, bias)]
        out = group_norm_reference(*inputs, num_groups, eps, relu)
        return torch.autograd.grad(out, inputs, grad_out)


class _GroupNormKernel(torch.autograd.Function):
    """Kernel forward; backward through the plain version's autograd."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, relu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, relu)
        return _group_norm_cuda(x, scale, bias, num_groups, eps, relu)

    @staticmethod
    def backward(ctx, grad_out):
        grads = group_norm_backward(grad_out, *ctx.saved_tensors, *ctx.args)
        return (*grads, None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = DEFAULT_EPS,
               relu: bool = False, impl: str = "auto") -> torch.Tensor:
    """Fused GroupNorm(+ReLU) over NHWC ``x`` with per-channel ``scale``
    and ``bias``; the output has ``x``'s dtype."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    _validate_groups(x.shape[3], num_groups)
    if resolve_impl(impl, x) == "torch":
        return group_norm_reference(x, scale, bias, num_groups, eps, relu)
    return _GroupNormKernel.apply(x, scale, bias, num_groups, eps, relu)
