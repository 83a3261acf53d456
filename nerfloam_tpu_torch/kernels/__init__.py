"""Build and load the port's hand-written CUDA kernels.

Each source in ``nerfloam_tpu_torch/csrc/*.cu`` exposes a plain C
interface. At first use every source is compiled by its own ``nvcc``
process for ``sm_90a``, all started together, into a shared library under
``kernels/build/`` (listed in .gitignore) whose file name carries a hash of
that source and the flags; the libraries are then loaded with ctypes and
their entry points gathered on one object. Pointers and the CUDA stream go
through ``ctypes.c_void_p``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises if it is not 0.

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
import types

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
    "nl_hits_field_bwd": [_P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _I, _P, _P],
    "nl_active_field_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _F,
                            _P, _P, _P, _P, _P],
    "nl_gn_partial_values": [],
    "nl_gn_blocks": [_I],
    "nl_gn_system": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                     _P, _P, _P, _P, _P],
    "nl_insert_elect": [_P, _P, _I, _F, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_insert_candidate": [_P, _P, _P, _P, _I, _P, _P],
    "nl_insert_corners": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "nl_insert_corner_new": [_P, _P, _I, _P, _P],
    "nl_insert_alloc": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    "nl_insert_activate": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "nl_insert_append": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _I, _I,
                         _P, _P, _P, _P, _P],
    "nl_recenter": [_P, _P, _I, _P, _I, _I, _I, _P, _P],
    "nl_refresh_mark": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "nl_refresh_place": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "nl_active_pack": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_reconcile_compact": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_reconcile_link": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_reconcile_apply": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P],
    "nl_march_occupancy": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _F, _F, _P, _P, _P],
    "nl_place_samples_cdf": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                             _P, _P, _P, _P, _P],
    "nl_mesh_lattice": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "nl_marching_tets": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "nl_build_prev_scan": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P],
    "nl_s2s_partial_values": [],
    "nl_s2s_blocks": [_I],
    "nl_s2s_system": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                      _F, _F, _P, _P, _P, _P, _P],
}

_lib = None
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(os.path.basename(src).encode() + f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build() -> list[str]:
    """Compile every source whose hashed library is missing, one nvcc per
    source, all at once; return the library paths. Records the wall
    seconds and each compiler's output in ``build_info``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [library_path(s) for s in sources()]
    t0 = time.perf_counter()
    procs = []
    for src, path in zip(sources(), paths):
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            procs.append((src, path, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    logs = build_info.setdefault("log", {})
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[os.path.basename(src)] = out
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["built"] = [os.path.basename(p[0]) for p in procs]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def lib() -> types.SimpleNamespace:
    """The entry points of every kernel library, built at first call."""
    global _lib
    if _lib is None:
        fns = {}
        for path in build():
            loaded = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
        missing = sorted(set(_SIGNATURES) - set(fns))
        if missing:
            raise RuntimeError(f"kernel entry points missing from the libraries: {missing}")
        _lib = types.SimpleNamespace(**fns)
    return _lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
