"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

at first use, from the sources in this checkout, into ``build/kernels``
beside the package (a directory ``.gitignore`` lists). The file name
carries a hash of the sources and flags, so a changed source builds
anew. A build that fails raises :class:`KernelBuildError` with nvcc's
output; nothing falls back. ``-Xptxas -v`` output (registers, shared
memory, spills per kernel) is kept in ``build_log(name)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent import futures
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_build_s: dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def kernel_names() -> list[str]:
    """Every kernel source of the port (``ops/csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels build from source on the machine with the card")


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    return [src] + sorted(CSRC.glob("*.cuh"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` for this source hash lives."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _compile(name: str) -> Path:
    """Compile ``name`` unless the library for this source hash exists;
    returns its path. Writes to a temporary name and renames, so a
    concurrent build never loads a half-written library."""
    lib = library_path(name)
    if lib.exists():
        _logs.setdefault(name, "(cached build)")
        _build_s.setdefault(name, 0.0)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(_sources(name)[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _build_s[name] = time.perf_counter() - t0
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{_logs[name]}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_compile(name)))
        return _libs[name]


def build_all() -> dict[str, float]:
    """Build every kernel source at once, one nvcc per source, all started
    together; returns the seconds each build took. Raises on the first
    failure after every build has ended."""
    names = kernel_names()
    with futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        done = [pool.submit(load, n) for n in names]
        for f in done:
            f.result()
    return {n: _build_s.get(n, 0.0) for n in names}


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (``-Xptxas -v`` resource usage)."""
    return _logs.get(name, "")
