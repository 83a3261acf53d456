"""Build and load the port's hand-written CUDA kernels.

The sources in ``nerfloam_tpu_torch/csrc/*.cu`` expose a plain C
interface. At first use they are compiled by ``nvcc`` for ``sm_90a`` into
one shared library under ``kernels/build/`` (listed in .gitignore) whose
file name carries a hash of the sources and flags, then loaded with
ctypes. Pointers and the CUDA stream go through ``ctypes.c_void_p``; every
entry point returns ``cudaGetLastError()`` and :func:`check` raises if it
is not 0.

Flags: no ``--use_fast_math``, and ``-fmad=false`` so that no product is
contracted into an FMA: the cell of a sample is ``floor(xyz / vs)`` and a
contracted ``o + d*z`` or an approximate division would move samples across
voxel faces, breaking exact agreement with the plain torch versions.

Nothing is built or loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nl_hit_table": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F,
                     _P, _P, _P, _P, _P, _P, _P],
    "nl_hit_table_max_hits": [],
    "nl_hits_field_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                          _P, _P, _P, _P, _P, _P],
    "nl_hits_field_bwd": [_P, _P, _P, _P, _P, _I, _F, _P, _P, _P],
}

_lib = None
build_info: dict = {}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libnerfloam_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build() -> str:
    """Compile the sources into the hashed library unless it exists; return
    its path. Records seconds and the compiler's output in ``build_info``."""
    path = library_path()
    if os.path.exists(path):
        build_info.setdefault("seconds", 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_info['log']}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
