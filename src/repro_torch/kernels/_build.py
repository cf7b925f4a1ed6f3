"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/`` directory at its first use, and loaded with
``ctypes``. The library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale build is never loaded.
``build()`` starts one ``nvcc`` per source, all at once, under a file
lock: ranks that reach a fresh tree together (``torchrun``) build each
library once, and the others wait for it and load it.

A library may hold more than one entry point: ``<library>.<path>`` names
a second one (``axllm_matmul.wgmma``, ``flash_attention.wgmma``: the
tensor-core paths; ``axllm_matmul.gemv``, ``reuse_matmul.gemv``: the
split-K decode kernels). Every wrapper
adds one to ``LAUNCHES[library]`` where it launches a kernel of that
library and nowhere else, and one to ``LAUNCHES["<library>.<path>"]``
when it takes such a second entry point, so a run can show that its main
path went through the kernels, and through which of them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point (all return cudaError_t), by kernel
# name: "<library>" or "<library>.<path>"
SIGNATURES = {
    "axllm_matmul": ("axllm_matmul_launch",
                     [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "axllm_matmul.wgmma": ("axllm_matmul_wgmma_launch",
                           [_P] * 5 + [_I] * 8 + [_P]),
    "axllm_matmul.gemv": ("axllm_matmul_gemv_launch",
                          [_P, _I, _P, _P, _P, _P, _I, _P, _P] + [_I] * 8
                          + [_P]),
    "decode_attention": ("decode_attention_launch",
                         [_P] * 9 + [_I] * 9 + [_F, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P]),
    "flash_attention.wgmma": ("flash_attention_wgmma_launch",
                              [_P] * 4 + [_I] * 7 + [_F, _P]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_P] * 9 + [_I] * 8 + [_F, _P]),
    "reuse_matmul": ("reuse_matmul_launch",
                     [_P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P]),
    "reuse_matmul.wgmma": ("reuse_matmul_wgmma_launch",
                           [_P] * 6 + [_I] * 11 + [_P]),
    "reuse_matmul.gemv": ("reuse_matmul_gemv_launch",
                          [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P] + [_I] * 11
                          + [_P]),
    "paged_decode_attention": ("paged_decode_attention_launch",
                               [_P] * 10 + [_I] * 11 + [_F, _P]),
    "quantize": ("quantize_launch", [_P, _I, _P, _P] + [_I] * 10 + [_P]),
}

# the CUDA sources, one shared library each
LIBRARIES = tuple(dict.fromkeys(name.split(".")[0] for name in SIGNATURES))

LAUNCHES: collections.Counter = collections.Counter()
_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The device's number of SMs (a host-side property)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory (released when the
    process ends, so a killed build leaves none behind)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source in parallel, holding the build lock. Returns the
    compiler output (register and spill counts from ``-Xptxas -v``) of
    each library it built."""
    with _build_lock():
        return _build(names)


def _build(names) -> Dict[str, str]:
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def launcher(name: str):
    """The C launch function of kernel ``name``, its library built on first
    use."""
    if name not in _LOADED:
        lib = name.split(".")[0]
        build([lib])
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(target(lib))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return _LOADED[name]


def launch(name: str, *args) -> None:
    """Launch kernel ``name``; raise if CUDA refused the launch."""
    err = launcher(name)(*args)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    lib = name.split(".")[0]
    LAUNCHES[lib] += 1
    if name != lib:
        LAUNCHES[name] += 1
