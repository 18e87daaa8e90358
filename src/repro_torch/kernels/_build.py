"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together; a last ``nvcc`` links
the objects into one shared library with a plain C interface. The library
lands in ``build/repro_torch/`` at the repository root, named by a hash of
the sources and flags, so unchanged sources load the existing library and
an edited one rebuilds. Nothing is compiled when this module is imported:
the first wrapper that meets a CUDA tensor calls :func:`library`. A failed
build raises; no caller falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# storage dtype -> the code the C entry points take (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# C entry points and their argument types: a pointer (and the stream) as
# c_void_p, every count as c_int64 (R*N passes 2**31 at full width).
SIGNATURES = {
    # idx, val, mask, w, out, R, B, K, NF, H, dtype, stream
    "spmm_forward": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P],
    # rows, samp, scale, dh, out, head, tail, R, S, B, NF, H, chunk, stream
    "spmm_grad_w": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P],
    # reps, alphas, g, gp, gamma, out, R, N, dtype, momentum, stream
    "weighted_merge": [_P, _P, _P, _P, ctypes.c_float, _P, _I64, _I64, _I64, _I64, _P],
    # q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal, window, dtype, stream
    "flash_attention": [_P, _P, _P, _P] + [_I64] * 9 + [_P],
    # x, dA, Bm, Cm, y, final, scratch (a, chunk states, states in), B, L,
    # H, P, N, chunk, Bm/Cm strides (b, l, h), x dtype, Bm/Cm dtype, stream
    "ssd_scan": [_P] * 9 + [_I64] * 11 + [_P],
    # buf, wi, wg, wo, scratch, out, E, C, D, F, dtype, stream
    "moe_ffn_gmm": [_P] * 6 + [_I64] * 5 + [_P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the library is already built."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed to compile\n" + "\n".join(failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
        # atomic publish: a process building at the same time never loads a partial file
        os.replace(staged, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a failed launch."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")
