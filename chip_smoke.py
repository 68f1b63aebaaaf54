#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Four phases, each printing one JSON line:

1. **device** — the card (``nvidia-smi`` name and power limit), the torch
   and CUDA versions, and the build of every kernel source under
   ``mmlspark_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all started
   together) with the registers and spills ``ptxas`` reports;
2. **kernel** — each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (ViT-B/16 attention: B in
   {1, 8, 32}, H=12, T=196, D=64, bf16 and f32, on the strided
   ``[B,T,H,D] → [B,H,T,D]`` view the model passes) and at the edge cases
   (fully masked rows, causal, ragged T=77, D in {32, 128}), with its
   time, the plain version's, one PyTorch library call's and the bound;
3. **serve** — ViT-B/16 at full width (weights from a seed) served through
   ``ModelServer(ServeConfig(buckets=(1, 8, 32)))``: concurrent requests
   of 1–20 uint8 224×224×3 images; every answer held against the same rows
   through the plain-attention path on the card; the kernel's launch count
   over the run must be exactly 12 per forward, warmup included;
4. **kernels** — one line listing every ported kernel.

Then the card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it,
as does a machine without CUDA or a directory without the package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM data sheet, dense): bytes/s of
# device memory and operations/s by operand type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain version: both accumulate in float32 from the same
# float32 operands (bf16 inputs are upcast exactly); they differ in
# summation order and in expf against torch.exp
KERNEL_TOL = 1e-4

# served (kernel attention) vs the plain-attention path, on logits: both
# run every layer in bfloat16, so a last-bit difference in one attention
# output can flip a bfloat16 rounding, which the residual stream carries
# through 12 blocks; the two paths also pack rows into different batch
# shapes, so the GEMMs may round differently. Measured 1.6e-2 on logits
# of magnitude up to 3.7 (one bfloat16 step in [2, 4)); the tolerance is
# three such steps
SERVE_TOL = 5e-2

VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM = 12, 196, 64
SERVE_BUCKETS = (1, 8, 32)
SERVE_CLIENTS = 6
SERVE_REQUESTS_PER_CLIENT = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each
    call. A busy-wait kernel ahead of each sample keeps the stream
    backed up, so the events time the device work and not the host's
    launch gap."""
    import torch
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def attention_bound(b, h, tq, tk, d, dtype) -> tuple[float, str]:
    """The least time in ms for flash attention on these operands: each
    input read once (q/k/v in their type, the int8 mask), the f32 output
    written once, and 4·B·H·Tq·Tk·D operations at the peak for the
    operand type. Returns (ms, "bytes" | "operations")."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (tq + 2 * tk) * d * elt + b * h * tq * d * 4
              + b * tq * tk)
    ops = 4 * b * h * tq * tk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    import torch

    from mmlspark_tpu_torch.ops import _build
    card = nvidia_smi()
    t0 = time.perf_counter()
    build_s = _build.build_all()
    wall = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in build_s}
    out = {"phase": "device", "nvidia_smi": card,
           "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "build_wall_s": wall, "build_s": build_s, "ptxas": ptxas}
    emit(out)
    return out


def _attention_inputs(b, h, t, d, dtype, gen, strided):
    import torch
    shape = (b, t, h, d) if strided else (b, h, t, d)
    qkv = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
           for _ in range(3)]
    # the model's view: [B, T, H, D] projections seen as [B, H, T, D]
    return [x.transpose(1, 2) if strided else x for x in qkv]


def phase_kernel() -> dict:
    """Every flash-attention case against the plain version; timings at
    the ViT-B/16 shapes. Returns the figures of the main path's shape
    (B=32, bf16) plus the largest error over every case."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for b in (1, 8, 32):
        for dt in (bf16, f32):
            cases.append(dict(b=b, h=VIT_HEADS, t=VIT_TOKENS,
                              d=VIT_HEAD_DIM, dtype=dt, lens=None,
                              causal=False, strided=True, timed=True))
    cases += [
        dict(b=4, h=12, t=196, d=64, dtype=bf16, lens=(196, 0, 100, 1),
             causal=False, strided=True, timed=False),
        dict(b=2, h=12, t=196, d=64, dtype=f32, lens=None, causal=True,
             strided=False, timed=False),
        dict(b=4, h=8, t=77, d=64, dtype=bf16, lens=(77, 40, 77, 3),
             causal=True, strided=False, timed=False),
        dict(b=4, h=12, t=196, d=32, dtype=f32, lens=None, causal=False,
             strided=True, timed=False),
        dict(b=4, h=12, t=196, d=128, dtype=bf16, lens=None, causal=False,
             strided=False, timed=False),
    ]
    worst = 0.0
    main = None
    for c in cases:
        q, k, v = _attention_inputs(c["b"], c["h"], c["t"], c["d"],
                                    c["dtype"], gen, c["strided"])
        kv = None
        if c["lens"] is not None:
            kv = (torch.arange(c["t"], device="cuda")[None, :]
                  < torch.tensor(c["lens"], device="cuda")[:, None])
        got = fa.flash_attention(q, k, v, kv_mask=kv, causal=c["causal"])
        torch.cuda.synchronize()
        want = fa.flash_attention(q, k, v, kv_mask=kv, causal=c["causal"],
                                  impl="torch")
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"kernel output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        dtype_name = str(c["dtype"]).replace("torch.", "")
        row = {"phase": "kernel", "kernel": "flash_attention",
               "B": c["b"], "H": c["h"], "T": c["t"], "D": c["d"],
               "dtype": dtype_name, "kv_lens": c["lens"],
               "causal": c["causal"], "strided": c["strided"],
               "max_abs_err": err, "tol": KERNEL_TOL}
        if c["lens"] is not None and 0 in c["lens"]:
            dead = c["lens"].index(0)
            check(bool((got[dead] == 0).all()),
                  "fully masked rows are not exact zeros")
            row["masked_rows_exact_zero"] = True
        if c["timed"]:
            keep = fa.mask3(c["b"], c["t"], c["t"], None, False, q.device)
            scale = fa.resolve_scale(None, c["d"])
            row["ms"] = time_ms(lambda: fa._flash_cuda(q, k, v, keep,
                                                       scale))
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, keep, scale))
            attn_mask = keep[:, None].bool()
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, scale=scale))
            bound_ms, bound_by = attention_bound(
                c["b"], c["h"], c["t"], c["t"], c["d"], dtype_name)
            row["bound_ms"] = bound_ms
            row["bound_us"] = bound_ms * 1e3
            row["bound_by"] = bound_by
            if c["b"] == max(SERVE_BUCKETS) and c["dtype"] == bf16:
                main = row
        emit(row)
        check(err <= KERNEL_TOL,
              f"flash_attention kernel differs from its plain version by "
              f"{err} > {KERNEL_TOL} on {row}")
    return {**main, "max_abs_err": worst}


def _set_attention_impl(module, impl: str) -> None:
    from mmlspark_tpu_torch.models.vit import BhtdSelfAttention
    for m in module.modules():
        if isinstance(m, BhtdSelfAttention):
            m.impl = impl


def phase_serve(card: str, kernel_ms: float) -> int:
    """Serve full-width ViT-B/16; returns the kernel launches of the
    run. ``kernel_ms`` is the kernel's time at the largest bucket, for
    the share of a forward it takes."""
    import torch

    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.serve.config import ServeConfig
    from mmlspark_tpu_torch.serve.server import ModelServer

    t0 = time.perf_counter()
    bundle = get_model("ViT_B16", seed=0)
    model = TorchModel(model=bundle, input_col="image", output_col="scores")
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 21, SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT)
    images = rng.integers(0, 256, (int(sizes.sum()), 224, 224, 3),
                          dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    setup_s = time.perf_counter() - t0
    answers: dict[int, np.ndarray] = {}
    latencies: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(idx: int, server: ModelServer) -> None:
        try:
            for r in range(idx, len(sizes), SERVE_CLIENTS):
                rows = list(images[offsets[r]:offsets[r] + sizes[r]])
                t = time.perf_counter()
                out = server.predict("vit", DataTable({"image": rows}),
                                     timeout=300)
                lat = (time.perf_counter() - t) * 1e3
                with lock:
                    answers[r] = np.stack(out["scores"])
                    latencies.append(lat)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    # the main path: launch counts from 0 just before, read just after
    fa.launches = 0
    t_load = time.perf_counter()
    server = ModelServer(ServeConfig(buckets=SERVE_BUCKETS))
    try:
        server.add_model("vit", model,
                         example=DataTable({"image": [images[0]]}))
        load_s = time.perf_counter() - t_load
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, server))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        serve_s = time.perf_counter() - t_serve
        snap = server.snapshot()["vit"]
    finally:
        server.close()
    launches = fa.launches
    if errors:
        raise errors[0]
    forwards = len(SERVE_BUCKETS) + snap["batches"]
    check(launches == 12 * forwards,
          f"{launches} kernel launches for {forwards} forwards "
          f"({len(SERVE_BUCKETS)} warmup + {snap['batches']} batches); "
          "expected 12 per forward")
    check(snap["completed"] == len(sizes) and snap["failed"] == 0,
          f"serving stats {snap}")

    # one forward at the largest bucket, timed on the device, with the
    # kernel and then with the plain attention
    x = torch.from_numpy(images[:max(SERVE_BUCKETS)]).cuda()
    forward_ms = time_ms(lambda: model.device_forward(x), reps=20)

    # the same rows through the same weights with the plain attention
    _set_attention_impl(bundle.module, "flash_torch")
    launched = fa.launches
    plain_forward_ms = time_ms(lambda: model.device_forward(x), reps=20)
    ref = np.stack(model.transform(
        DataTable({"image": list(images)}))["scores"])
    check(fa.launches == launched, "the plain path launched the kernel")
    worst = 0.0
    for r, got in answers.items():
        check(got.shape == (sizes[r], 1000), f"answer shape {got.shape}")
        check(bool(np.isfinite(got).all()), "non-finite answer")
        want = ref[offsets[r]:offsets[r] + sizes[r]]
        worst = max(worst, float(np.abs(got - want).max()))
    lat = np.asarray(latencies)
    emit({"phase": "serve", "model": "ViT_B16", "card": card,
          "buckets": list(SERVE_BUCKETS), "clients": SERVE_CLIENTS,
          "requests": int(len(sizes)), "rows": int(sizes.sum()),
          "request_sizes": sizes.tolist(),
          "forwards": forwards, "batches": snap["batches"],
          "occupancy_by_bucket": snap["occupancy_by_bucket"],
          "kernel_launches": launches, "launches_per_forward":
          launches / forwards, "setup_s": setup_s, "load_warm_s": load_s,
          "serve_wall_s": serve_s,
          "requests_per_s": len(sizes) / serve_s,
          "rows_per_s": float(sizes.sum()) / serve_s,
          "latency_p50_ms": float(np.percentile(lat, 50)),
          "latency_p99_ms": float(np.percentile(lat, 99)),
          "device_ms_per_batch": snap["device_ms"],
          "forward_ms": {"batch": max(SERVE_BUCKETS), "kernel": forward_ms,
                         "plain_attention": plain_forward_ms,
                         "attention_kernel_share":
                         12 * kernel_ms / forward_ms},
          "max_abs_err_vs_plain_attention": worst,
          "logit_max_abs": float(np.abs(ref).max()), "tol": SERVE_TOL,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(worst <= SERVE_TOL,
          f"served logits differ from the plain-attention path by {worst} "
          f"> {SERVE_TOL}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.device import resolve_device
    resolve_device()  # the float32 precision policy, before any compute
    dev = phase_device()
    main_shape = phase_kernel()
    launches = phase_serve(dev["nvidia_smi"], main_shape["ms"])
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "mmlspark_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/pallas/attention.py:183",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
