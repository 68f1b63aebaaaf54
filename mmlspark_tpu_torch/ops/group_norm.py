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
* The kernel route's backward is a kernel too (two bodies in the same
  file, below): the JAX package's ``_gn_bwd`` is ``jax.vjp`` of its
  reference, and the kernel computes that vjp in closed form.
  :func:`group_norm_backward_reference` is its plain version (the same
  closed form in plain PyTorch, no autograd); :func:`group_norm_backward`
  (the plain forward recomputed under autograd) stays as a measured
  reference and nothing on the card's path calls it.
* ``launches`` counts calls that reach ``ops/csrc/group_norm.cu``'s
  forward: one per ``group_norm`` call, whichever body runs;
  ``cluster_launches`` counts those that ran the cluster body;
  ``backward_launches`` counts calls of the backward kernel, whichever
  body runs, ``backward_cluster_launches`` those that ran its cluster
  body, and ``backward_dy_copies`` the calls whose ``dy`` was not
  contiguous in NHWC order and was copied first.

The kernel file has two bodies, chosen by shape (:func:`cluster_plan`):

* **the cluster body** (``gn_cluster``): one CUDA launch per call and one
  thread-block cluster of ``k`` CTAs per sample, each CTA holding a slab
  of the sample's rows in shared memory, so that ``x`` is read from
  device memory once; the statistics are exchanged inside the cluster in
  a fixed order, so two launches give the same bits. It takes every
  sample that fits ``k`` × 227 KB with its tables (``k`` up to 16 where
  the card holds such clusters), which is every ResNet-50 site at 224²,
  bf16 or f32. The plan is taken once per shape and card.
* **the tiled body**, three launches (``gn_tile_stats``, ``gn_merge``,
  ``gn_apply``, cut by :func:`plan`) for samples that do not fit, such as
  f32 at 112×112×128 (6.4 MB a sample). It needs f32 scratch for the
  tiles' partials and the statistics, which the wrapper allocates only
  for it.

The backward has two bodies too, chosen by shape
(:func:`backward_cluster_plan`); both recompute the statistics from
``x``, use no float atomics (two launches on one input give the same
bits) and pass half the gradient at ``y == 0``, as ``jnp.maximum`` does
in the JAX package:

* **the cluster body** (``gn_bwd_cluster`` and ``gn_bwd_fold``, two CUDA
  launches a call): one cluster of ``k`` CTAs a sample, each CTA holding
  a slab of the sample's rows of ``x`` and ``dy`` in shared memory, so
  that both are read from device memory once; the forward's cluster
  statistics, then the sums of ``gy`` and ``gy·x̂`` per channel and their
  group means ``c1``, ``c2`` exchanged inside the cluster in a fixed
  order, ``dx`` from shared memory, and each sample's per-channel sums to
  a float32 scratch ``[N, C, 2]`` that the second launch folds over the
  samples in order into ``dscale`` and ``dbias``. It takes every sample
  whose ``x`` and ``dy`` fit ``k`` × 227 KB, which is every bf16
  ResNet-50 site at 224².
* **the five-launch body** for samples that do not fit (f32 at 112×112×64,
  56×56×256 or 112×112×128): it cuts each sample into tiles of rows
  (:func:`backward_plan`) and passes over them four times: the tiles'
  moments per group (``gn_bwd_stats``, merged into the statistics by the
  tiled body's ``gn_merge``), the sums of ``gy`` and ``gy·x̂`` per tile
  and channel (``gn_bwd_reduce``), those folded over the tiles, the
  groups' channels and the samples in a fixed order (``gn_bwd_merge``),
  and ``dx`` (``gn_bwd_apply``).

The kernel takes ``x`` contiguous in NHWC order (an NCHW tensor in
``torch.channels_last`` seen through ``permute(0, 2, 3, 1)`` is that), in
float32 or bfloat16, with float32 ``scale``/``bias`` of ``[C]``; the
wrapper raises on any other layout or dtype rather than copying. A base
pointer or a row of ``C`` elements that is not a multiple of 16 bytes
makes the cluster body copy in 8-, 4- or 2-byte words instead.
"""

from __future__ import annotations

import ctypes
import functools
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

# the cluster body: the largest cluster (16 CTAs; clusters above 8 are
# non-portable, and a plan takes a cluster size only where the card's
# occupancy query holds at least one such cluster), the dynamic shared
# memory a CTA may take (227 KB), the most a CTA may take for two to share
# an SM (228 KB less 1 KB reserved a CTA, halved), its block width, and
# the share of the SMs a call's CTAs should reach
_MAX_CLUSTER = 16
_MAX_SMEM = 232_448
_TWO_PER_SM_SMEM = (233_472 - 2 * 1_024) // 2
_CLUSTER_THREADS = 256
_SMS = 132
_WIDEST_WORD = 16

# the backward's tiles of rows: at least this many rows a tile (so the
# float2 partials of a tile stay small against its rows); and the CTAs of
# its tile kernels an H100 holds at once, estimated without the card
# (three 256-thread CTAs an SM, the registers of the bf16 kernels)
_BWD_MIN_ROWS = 16
_BWD_RESIDENT = 3 * _SMS

# launches of the CUDA kernel (either body) and of its cluster body, calls
# of the backward kernel (either body) and of its cluster body, and the
# backward's copies of a non-contiguous dy; reset by whoever reads them
launches = 0
cluster_launches = 0
backward_launches = 0
backward_cluster_launches = 0
backward_dy_copies = 0
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
        # torch.maximum passes half the gradient at a tie, as jnp.maximum
        # does (clamp_min would pass all of it)
        out = torch.maximum(out, out.new_zeros(()))
    return out.to(x.dtype)


def _backward_terms(dy, x, scale, bias, num_groups: int, eps: float,
                    relu: bool) -> dict:
    """The closed form's float32 terms, each ``[N, H·W, G, cg]`` or
    broadcastable to it: ``r``, ``xhat``, ``y``, ``gy`` (``dy`` times the
    ReLU's derivative, 0.5 at ``y == 0``), ``s``, ``b``, and per (sample,
    group) ``c1``, ``c2``; ``A``, ``B`` are ``[N, G, cg]``."""
    n, h, w, c = x.shape
    _validate_groups(c, num_groups)
    cg = c // num_groups
    shape = (n, h * w, num_groups, cg)
    xf = x.float().reshape(shape)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mean) * r
    s = scale.float().reshape(1, 1, num_groups, cg)
    b = bias.float().reshape(1, 1, num_groups, cg)
    y = xhat * s + b
    gy = dy.float().reshape(shape)
    if relu:
        gy = gy * torch.where(y > 0, 1.0, torch.where(y == 0, 0.5, 0.0))
    a_sum = gy.sum(dim=1)
    b_sum = (gy * xhat).sum(dim=1)
    m = float(h * w * cg)
    c1 = (s[0] * a_sum).sum(dim=-1, keepdim=True)[:, None] / m
    c2 = (s[0] * b_sum).sum(dim=-1, keepdim=True)[:, None] / m
    return {"r": r, "xhat": xhat, "y": y, "gy": gy, "s": s, "b": b,
            "c1": c1, "c2": c2, "A": a_sum, "B": b_sum}


def group_norm_backward_reference(dy, x, scale, bias, num_groups: int,
                                  eps: float = DEFAULT_EPS,
                                  relu: bool = False):
    """The gradients ``(dx, dscale, dbias)`` of :func:`group_norm_
    reference` at ``dy``, in closed form in plain PyTorch (no autograd):
    ``dx = r·(gy·s − c1 − x̂·c2)`` rounded once to ``x``'s dtype, with
    ``c1``, ``c2`` the group means of ``s·gy`` and ``s·gy·x̂``; ``dscale``
    ``= Σ gy·x̂`` and ``dbias = Σ gy`` over samples and rows, float32."""
    t = _backward_terms(dy, x, scale, bias, num_groups, eps, relu)
    dx = t["r"] * (t["gy"] * t["s"] - t["c1"] - t["xhat"] * t["c2"])
    c = x.shape[3]
    return (dx.reshape(x.shape).to(x.dtype), t["B"].sum(0).reshape(c),
            t["A"].sum(0).reshape(c))


def backward_error_bound(dy, x, scale, bias, num_groups: int, rel: float,
                         eps: float = DEFAULT_EPS, relu: bool = False,
                         exact=None):
    """How far a float32 evaluation of the closed form may lie from
    :func:`group_norm_backward_reference` when its sums run in another
    order and its statistics differ by ``rel`` of a term's magnitude:
    ``(dx, dscale, dbias)`` bounds, before any rounding of ``dx`` to a
    narrower type.

    * ``dx``: ``rel · r·(|gy·s| + |c1|' + (|x̂| + 1)·|c2|')``: each term
      of ``r·(gy·s − c1 − x̂·c2)`` by its own size, where ``|c1|'`` and
      ``|c2|'`` are the group means of ``|s·gy|`` and ``|s·gy·x̂|`` (a sum
      taken in another order moves by a share of its terms' sizes, not of
      its own) and ``x̂`` itself may be off by ``rel·(|x̂| + 1)`` (its
      ``r`` relatively, its mean by ``rel`` of the spread);
    * ``dscale``: ``rel · Σ|gy|·(|x̂| + 1)``; ``dbias``: ``rel · Σ|gy|``;
    * with the ReLU, an element whose ``y`` lies within ``rel·(|s|·(|x̂|
      + 1) + |b|)`` of 0 may take either side of the ReLU (the two sides
      compute ``y`` with other roundings): its own ``dx`` may then move by
      ``r·|dy·s|``, its group's ``c1``, ``c2`` by ``|s·dy|/M`` and
      ``|s·dy·x̂|/M``, its channel's ``dbias`` by ``|dy|`` and ``dscale``
      by ``|dy·x̂|``. ``exact`` (a bool ``[N, H, W, C]`` mask) marks
      elements whose ``y`` both sides compute exactly (a group of zeros
      with bias 0: ``y`` is 0 on both sides, the ReLU's tie), which get
      no such allowance."""
    n, h, w, c = x.shape
    t = _backward_terms(dy, x, scale, bias, num_groups, eps, relu)
    r, xhat, gy, s = t["r"], t["xhat"], t["gy"], t["s"]
    agy, ax1 = gy.abs(), xhat.abs() + 1
    m = float(h * w * (c // num_groups))
    sgy = (gy * s).abs()
    c1 = sgy.sum(dim=(1, 3), keepdim=True) / m
    c2 = (sgy * xhat.abs()).sum(dim=(1, 3), keepdim=True) / m
    dx = rel * r * (sgy + c1 + ax1 * c2)
    dscale = rel * (agy * ax1).sum(dim=(0, 1))
    dbias = rel * agy.sum(dim=(0, 1))
    if relu:
        near = t["y"].abs() <= rel * (s.abs() * ax1 + t["b"].abs())
        if exact is not None:
            near = near & ~exact.reshape(near.shape)
        ady = dy.float().reshape(gy.shape).abs() * near
        dc1 = (s.abs() * ady).sum(dim=(1, 3), keepdim=True) / m
        dc2 = (s.abs() * ady * xhat.abs()).sum(dim=(1, 3), keepdim=True) / m
        dx = dx + r * (ady * s.abs() + dc1 + xhat.abs() * dc2)
        dscale = dscale + (ady * xhat.abs()).sum(dim=(0, 1))
        dbias = dbias + ady.sum(dim=(0, 1))
    return dx.reshape(x.shape), dscale.reshape(c), dbias.reshape(c)


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` → the kernel for CUDA tensors, the plain version for CPU
    tensors. ``cuda`` on CPU tensors raises. Meta tensors (a shape trace,
    no data) take the plain version whatever the route asked for."""
    if impl not in IMPLS:
        raise ValueError(f"unknown group_norm impl {impl!r}; one of {IMPLS}")
    if x.is_meta:
        return "torch"
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(
            "impl='cuda' runs the CUDA kernel and needs CUDA tensors; "
            f"got tensors on {x.device}")
    return impl


def plan(n: int, hw: int, c: int) -> dict:
    """How the tiled body (three launches) cuts one call: the statistics
    tiles (rows of H·W per tile, tiles per sample), the threads of a
    statistics block (channel threads × row threads) and the normalise
    blocks per sample."""
    ntiles = max(1, min(hw, -(-_STATS_BLOCKS // n)))
    tile_rows = -(-hw // ntiles)
    ntiles = -(-hw // tile_rows)
    ct = min(c, _THREADS)
    rt = max(1, _THREADS // ct)
    apply_blocks = max(1, min(-(-_APPLY_BLOCKS // n),
                              hw // _APPLY_ROWS))
    return {"ntiles": ntiles, "tile_rows": tile_rows, "ct": ct, "rt": rt,
            "apply_blocks": apply_blocks}


def backward_plan(n: int, hw: int, resident: int = _BWD_RESIDENT) -> dict:
    """How the backward's passes cut one call: ``ntiles`` tiles a sample
    of ``tile_rows`` rows, as many as one wave of the ``resident`` CTAs
    the card holds at once gives each sample (the wrapper asks the card),
    at least _BWD_MIN_ROWS rows a tile where a sample has them. One full
    wave beat both fewer, longer tiles and more, shorter ones at every
    ResNet-50 site on an H100."""
    ntiles = max(1, min(resident // n, hw // _BWD_MIN_ROWS))
    tile_rows = -(-hw // ntiles)
    return {"ntiles": -(-hw // tile_rows), "tile_rows": tile_rows}


def vector_bytes(c: int, elt: int, align: int = _WIDEST_WORD) -> int:
    """The widest word (16, 8, 4 or 2 bytes, never below one element)
    that divides a row of ``c`` elements of ``elt`` bytes and the data
    pointers' alignment ``align``: every copy, load and store of the
    cluster body moves one such word."""
    for vb in (16, 8, 4, 2):
        if vb >= elt and (c * elt) % vb == 0 and align % vb == 0:
            return vb
    return elt


def segment(c: int, groups: int, vec: int) -> int:
    """Channels a thread folds together before its vector's sums leave
    registers: a whole group where a vector holds whole groups, the whole
    vector where a group holds whole vectors, else one channel."""
    cg = c // groups
    if vec % cg == 0:
        return cg
    if cg % vec == 0:
        return vec
    return 1


def cluster_smem(rows: int, c: int, groups: int, elt: int, vec: int,
                 threads: int, seg: int) -> int:
    """Bytes of shared memory a CTA of the cluster body takes: its slab
    of ``rows × c`` elements (rounded up to 16 bytes), 20 bytes a group
    for the exchanged partials and the statistics, and two buffers of one
    float per (row thread, segment). The ``.cu`` file's ``cluster_smem``
    carves the same."""
    cv = c // vec
    rt = threads // min(cv, threads)
    slab = -(-rows * c * elt // 16) * 16
    return slab + 20 * groups + 8 * rt * (c // seg)


def resident_estimate(p: dict, ctas_per_sm: int = 4) -> int:
    """Clusters of plan ``p`` an H100 holds at once, estimated without
    the card: at most ``ctas_per_sm`` 256-thread CTAs an SM (four for the
    registers of the forward's bf16 body, two for the backward's launch
    bound), fewer where their shared memory runs out."""
    per_sm = min(ctas_per_sm, 233_472 // (p["smem"] + 1_024))
    return _SMS * per_sm // p["k"]


def _cluster_plans(n: int, hw: int, c: int, dtype: torch.dtype,
                   groups: int, align: int, resident, smem_of
                   ) -> dict | None:
    """The choice both cluster bodies make: for each ``k`` (a power of
    two up to 16) whose ``⌈hw/k⌉`` rows a CTA leave no CTA empty, with
    ``smem_of(rows, elt, vec, seg)`` bytes of shared memory a CTA of
    ``_CLUSTER_THREADS`` threads within 227 KB, the plan, if
    ``resident(plan)`` clusters of it fit the card at once (at least
    one); among those, in order: the fewest waves of ``n`` clusters;
    enough CTAs (``n·k``) to reach 7 of every 8 SMs; a CTA small enough
    for two to share an SM; the smallest ``k``."""
    elt = torch.empty((), dtype=dtype).element_size()
    vb = vector_bytes(c, elt, align)
    vec = vb // elt
    seg = segment(c, groups, vec)
    cover = _SMS - _SMS // 8
    plans = []
    k = 1
    while k <= _MAX_CLUSTER:
        rows = -(-hw // k)
        smem = smem_of(rows, elt, vec, seg)
        if (k == 1 or (k - 1) * rows < hw) and smem <= _MAX_SMEM:
            p = {"k": k, "rows": rows, "threads": _CLUSTER_THREADS,
                 "vec_bytes": vb, "seg": seg, "smem": smem}
            clusters = resident(p)
            if clusters >= 1:
                p["waves"] = -(-n // clusters)
                plans.append(p)
        k *= 2
    if not plans:
        return None
    return min(plans, key=lambda p: (p["waves"], n * p["k"] < cover,
                                     p["smem"] > _TWO_PER_SM_SMEM, p["k"]))


def cluster_plan(n: int, hw: int, c: int, dtype: torch.dtype, groups: int,
                 align: int = _WIDEST_WORD, resident=resident_estimate
                 ) -> dict | None:
    """How the cluster body cuts one call, or ``None`` where no cluster of
    up to 16 CTAs the card holds fits a sample in its shared memory (the
    tiled body then runs).

    ``k`` CTAs a sample (a power of two up to 16, every CTA with at
    least one row), each of ``threads`` threads holding ``rows`` = ⌈hw/k⌉
    rows (the last slab ragged). ``resident(plan)`` gives the
    clusters of a plan the card holds at once (the wrapper asks the
    card; :func:`resident_estimate` without it); a ``k`` of which none
    fits is not taken. Among the rest, in order: the fewest waves of
    ``n`` clusters; enough CTAs (``n·k``) to reach 7 of every 8 SMs; a
    slab small enough for two CTAs to share an SM; the smallest ``k``.
    ``align`` is the byte alignment of the data pointers."""
    return _cluster_plans(
        n, hw, c, dtype, groups, align, resident,
        lambda rows, elt, vec, seg: cluster_smem(
            rows, c, groups, elt, vec, _CLUSTER_THREADS, seg))


def backward_cluster_smem(rows: int, c: int, groups: int, elt: int,
                          vec: int, threads: int, seg: int) -> int:
    """Bytes of shared memory a CTA of the backward's cluster body takes:
    its slabs of ``rows × c`` elements of ``x`` and of ``dy`` (each
    rounded up to 16 bytes), 36 bytes a group and 8
    a channel for the exchanged partials, the statistics and ``c1``,
    ``c2``, and a work area of ``rt·max(ct·vec, 2·c/seg)`` floats. The
    ``.cu`` file's ``bwd_cluster_smem`` carves the same."""
    ct = min(c // vec, threads)
    rt = threads // ct
    slab = -(-rows * c * elt // 16) * 16
    return (2 * slab + 36 * groups + 8 * c
            + 4 * rt * max(ct * vec, 2 * (c // seg)))


def backward_cluster_plan(n: int, hw: int, c: int, dtype: torch.dtype,
                          groups: int, align: int = _WIDEST_WORD,
                          resident=functools.partial(resident_estimate,
                                                     ctas_per_sm=2)
                          ) -> dict | None:
    """How the backward's cluster body cuts one call, or ``None`` where no
    cluster of up to 16 CTAs the card holds fits a sample's ``x`` and
    ``dy`` in its shared memory (the five-launch body then runs). The
    choice is :func:`cluster_plan`'s, over :func:`backward_cluster_smem`;
    without the card, at most two CTAs an SM (the kernel's launch bound,
    128 registers a thread)."""
    return _cluster_plans(
        n, hw, c, dtype, groups, align, resident,
        lambda rows, elt, vec, seg: backward_cluster_smem(
            rows, c, groups, elt, vec, _CLUSTER_THREADS, seg))


# the argument types of each C entry point of ``ops/csrc/group_norm.cu``
# (pointers and the stream as ``c_void_p``, an output count as a pointer
# to ``c_int``)
_ARGTYPES = {
    "group_norm_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
    + [ctypes.c_float, ctypes.c_void_p],
    "group_norm_fwd_cluster": [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p],
    "group_norm_cluster_occupancy": [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int)],
    "group_norm_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "group_norm_bwd_resident": [ctypes.c_int] * 3
    + [ctypes.POINTER(ctypes.c_int)],
    "group_norm_bwd_cluster": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p],
    "group_norm_bwd_cluster_occupancy": [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int)],
}


def _kernel_fn(name: str = "group_norm_fwd"):
    """A C entry point of ``ops/csrc/group_norm.cu`` (``group_norm_fwd``,
    the tiled body; ``group_norm_fwd_cluster``; ``group_norm_cluster_
    occupancy``; ``group_norm_bwd``; ``group_norm_bwd_resident``;
    ``group_norm_bwd_cluster``; ``group_norm_bwd_cluster_occupancy``), built
    on first use, with every argument typed by :data:`_ARGTYPES`."""
    from mmlspark_tpu_torch.ops import _build
    fn = getattr(_build.load("group_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def cluster_occupancy(dtype: torch.dtype, p: dict) -> int:
    """How many clusters of plan ``p`` the current card holds at once
    (the query the cluster launch makes before it launches)."""
    out = ctypes.c_int(0)
    err = _kernel_fn("group_norm_cluster_occupancy")(
        _DTYPES[dtype], p["vec_bytes"], p["k"], p["threads"], p["smem"],
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"group_norm cluster occupancy query failed: "
                           f"cudaError {err} (plan {p})")
    return out.value


def backward_cluster_occupancy(dtype: torch.dtype, p: dict) -> int:
    """How many clusters of backward plan ``p`` the current card holds at
    once (the query the backward's cluster launch makes)."""
    out = ctypes.c_int(0)
    err = _kernel_fn("group_norm_bwd_cluster_occupancy")(
        _DTYPES[dtype], p["vec_bytes"], p["k"], p["threads"], p["smem"],
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"group_norm backward cluster occupancy query "
                           f"failed: cudaError {err} (plan {p})")
    return out.value


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


@functools.lru_cache(maxsize=None)
def _device_plan(n, hw, c, dtype, groups, align, device) -> dict | None:
    """:func:`cluster_plan` with the current card's occupancy query, once
    for each shape on each card."""
    return cluster_plan(n, hw, c, dtype, groups, align,
                        resident=lambda p: cluster_occupancy(dtype, p))


@functools.lru_cache(maxsize=None)
def _device_backward_plan(n, hw, c, dtype, vec_bytes, device) -> dict:
    """:func:`backward_plan` with the CTAs the current card holds at once
    (its occupancy query), once for each shape on each card."""
    out = ctypes.c_int(0)
    err = _kernel_fn("group_norm_bwd_resident")(
        _DTYPES[dtype], vec_bytes, c, ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(
            f"group_norm backward occupancy query failed: cudaError {err}, "
            f"{out.value} CTAs (C {c}, {dtype}, {vec_bytes}-byte words)")
    return backward_plan(n, hw, out.value)


@functools.lru_cache(maxsize=None)
def _device_backward_cluster_plan(n, hw, c, dtype, groups, align,
                                  device) -> dict | None:
    """:func:`backward_cluster_plan` with the current card's occupancy
    query, once for each shape on each card."""
    return backward_cluster_plan(
        n, hw, c, dtype, groups, align,
        resident=lambda p: backward_cluster_occupancy(dtype, p))


def _pointer_align(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    align = _WIDEST_WORD
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _group_norm_cuda(x, scale, bias, num_groups: int, eps: float,
                     relu: bool) -> torch.Tensor:
    """Launch the kernel on the current stream: the cluster body where
    :func:`cluster_plan` finds one, else the tiled body with its scratch.
    The output (and that scratch) is allocated here; the kernel allocates
    nothing."""
    global launches, cluster_launches
    _check_cuda_operands(x, scale, bias)
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cp = _device_plan(n, h * w, c, x.dtype, num_groups,
                          _pointer_align(x, out), x.device.index)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if cp is not None:
            fn = _kernel_fn("group_norm_fwd_cluster")
            with _count_lock:
                launches += 1
                cluster_launches += 1
            err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), _DTYPES[x.dtype], cp["vec_bytes"], n,
                     h * w, c, num_groups, cp["k"], cp["rows"],
                     cp["threads"], cp["seg"], cp["smem"], int(relu),
                     float(eps), stream)
        else:
            p = plan(n, h * w, c)
            fn = _kernel_fn()
            part = torch.empty((n, p["ntiles"], num_groups, 2),
                               dtype=torch.float32, device=x.device)
            stats = torch.empty((n, num_groups, 2), dtype=torch.float32,
                                device=x.device)
            with _count_lock:
                launches += 1
            err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), part.data_ptr(), stats.data_ptr(),
                     _DTYPES[x.dtype], n, h * w, c, num_groups,
                     p["tile_rows"], p["ntiles"], p["ct"], p["rt"],
                     p["apply_blocks"], _THREADS, int(relu), float(eps),
                     stream)
    if err != 0:
        body = f"cluster plan {cp}" if cp is not None else "the tiled body"
        raise RuntimeError(
            f"group_norm kernel launch failed: cudaError {err} "
            f"(x {tuple(x.shape)} {x.dtype}, groups {num_groups}, {body})")
    return out


def _group_norm_bwd_cuda(dy, x, scale, bias, num_groups: int, eps: float,
                         relu: bool):
    """Launch the backward kernel on the current stream; returns ``(dx,
    dscale, dbias)``, ``dx`` in ``x``'s dtype, the others float32: the
    cluster body where :func:`backward_cluster_plan` finds one, else the
    five-launch body. ``dy`` is copied to NHWC-contiguous first where it
    is not (counted in ``backward_dy_copies``). The outputs and the
    float32 scratch are allocated here; the kernel allocates nothing."""
    global backward_launches, backward_dy_copies
    if not x.is_cuda:
        raise ValueError("the group_norm backward kernel needs CUDA tensors; "
                         f"got x on {x.device}")
    _check_cuda_operands(x, scale, bias)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match "
            f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        with _count_lock:
            backward_dy_copies += 1
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    align = _pointer_align(x, dy, dx)
    with torch.cuda.device(x.device):
        cp = _device_backward_cluster_plan(n, h * w, c, x.dtype, num_groups,
                                           align, x.device.index)
    if cp is not None:
        return _group_norm_bwd_cluster(dy, x, scale, bias, num_groups, eps,
                                       relu, cp, dx)
    vb = vector_bytes(c, x.element_size(), align)
    f32 = dict(dtype=torch.float32, device=x.device)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    stats = torch.empty((n, num_groups, 2), **f32)
    coef = torch.empty((n, num_groups, 2), **f32)
    with torch.cuda.device(x.device):
        bp = _device_backward_plan(n, h * w, c, x.dtype, vb, x.device.index)
        part = torch.empty((n, bp["ntiles"], num_groups, 2), **f32)
        bpart = torch.empty((n, bp["ntiles"], c, 2), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = _kernel_fn("group_norm_bwd")
        with _count_lock:
            backward_launches += 1
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 dbias.data_ptr(), part.data_ptr(), stats.data_ptr(),
                 bpart.data_ptr(), coef.data_ptr(), _DTYPES[x.dtype], vb, n,
                 h * w, c, num_groups, bp["tile_rows"], bp["ntiles"],
                 int(relu), float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"group_norm backward kernel launch failed: cudaError {err} "
            f"(x {tuple(x.shape)} {x.dtype}, groups {num_groups}, "
            f"{vb}-byte words, tiles {bp})")
    return dx, dscale, dbias


def _group_norm_bwd_cluster(dy, x, scale, bias, num_groups: int, eps: float,
                            relu: bool, plan: dict, dx=None):
    """Launch the backward's cluster body with ``plan`` (a
    :func:`backward_cluster_plan`) on the current stream, ``x`` and ``dy``
    checked and NHWC-contiguous; returns ``(dx, dscale, dbias)`` into
    ``dx`` where given."""
    global backward_launches, backward_cluster_launches
    n, h, w, c = x.shape
    if dx is None:
        dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    part = torch.empty((n, c, 2), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = _kernel_fn("group_norm_bwd_cluster")
        with _count_lock:
            backward_launches += 1
            backward_cluster_launches += 1
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 dbias.data_ptr(), part.data_ptr(), _DTYPES[x.dtype],
                 plan["vec_bytes"], n, h * w, c, num_groups, plan["k"],
                 plan["rows"], plan["threads"], plan["seg"], plan["smem"],
                 int(relu), float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"group_norm backward kernel launch failed: cudaError {err} "
            f"(x {tuple(x.shape)} {x.dtype}, groups {num_groups}, "
            f"cluster plan {plan})")
    return dx, dscale, dbias


def group_norm_backward(grad_out, x, scale, bias, num_groups: int,
                        eps: float = DEFAULT_EPS, relu: bool = False):
    """The gradients of ``x``, ``scale`` and ``bias`` by autograd: the
    plain version recomputed and differentiated, as the JAX package's
    ``_gn_bwd`` does with ``jax.vjp``. A measured reference only; the
    kernel route's backward is :func:`_group_norm_bwd_cuda`."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, scale, bias)]
        out = group_norm_reference(*inputs, num_groups, eps, relu)
        return torch.autograd.grad(out, inputs, grad_out)


class _GroupNormKernel(torch.autograd.Function):
    """The forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, relu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, relu)
        return _group_norm_cuda(x, scale, bias, num_groups, eps, relu)

    @staticmethod
    def backward(ctx, grad_out):
        grads = _group_norm_bwd_cuda(grad_out, *ctx.saved_tensors,
                                     *ctx.args)
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
