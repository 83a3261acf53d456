"""Build and load the port's hand-written CUDA kernels.

Each source in ``nerfloam_tpu_torch/csrc/*.cu`` exposes a plain C
interface; the rounding they share lives in ``csrc/ieee.cuh`` and
``native/trig.h`` (sin, cos and atan2 as glibc rounds them). At first use every source is compiled by its own ``nvcc``
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
import threading
import time
import types

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
TRIG_HEADER = os.path.join(os.path.dirname(_HERE), "native", "trig.h")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long
_SIGNATURES = {
    "nl_hit_table": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _I, _F, _F,
                     _P, _P, _P, _P, _P, _P, _P, _P],
    "nl_hit_table_max_hits": [],
    "nl_hits_field_fwd": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _F, _F,
                          _P, _P, _P, _P, _P, _P],
    "nl_hits_field_bwd": [_P, _P, _P, _P, _P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P],
    "nl_hits_field_scan_tiles": [_I],
    "nl_active_field_fwd": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _F,
                            _P, _P, _P, _P, _P],
    "nl_gn_partial_values": [],
    "nl_gn_max_blocks": [],
    "nl_gn_system": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                     _P, _P, _P, _P, _P, _P],
    "nl_gn_system_maturity": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                              _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _P],
    "nl_insert_scan_words": [_I, _I],
    "nl_insert": [_P, _P, _I, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "nl_insert_undo": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "nl_recenter": [_P, _P, _I, _P, _I, _I, _I, _P, _P],
    "nl_refresh_mark": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "nl_refresh_place": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "nl_active_pack": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_reconcile_scan_tiles": [_I],
    "nl_reconcile": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P],
    "nl_pack_grad_build": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "nl_pack_grad": [_P, _P, _P, _I, _P, _P],
    "nl_march_occupancy": [_P, _P, _I, _P, _P],
    "nl_place_max_slots": [],
    "nl_place_args_layout": [_P],
    "nl_place_samples_cdf": [_P, _P, _P, _I, _P, _P, _P],
    "nl_mesh_lattice": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "nl_marching_tets": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "nl_marching_tets_tiles": [_I],
    "nl_marching_tets_compact": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nl_range_image_part_ints": [],
    "nl_build_prev_scan": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P],
    "nl_norm3": [_P, _I, _P, _P],
    "nl_trig_fwd": [_I, _P, _L, _P, _L, _I, _P, _P],
    "nl_trig_bwd": [_I, _P, _L, _P, _L, _P, _L, _I, _P, _P, _P],
    "nl_lm_step": [_P, _P, _I, _P, _P, _P],
    "nl_exp_so3_fwd": [_P, _L, _I, _P, _P],
    "nl_exp_so3_bwd": [_P, _L, _P, _I, _P, _P],
    "nl_ray_prep": [_P, _P, _I, _F, _F, _P, _P, _P, _P, _P, _P],
    "nl_s2s_system": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                      _F, _F, _I, _P, _P, _P, _P],
}

_lib = None
_lock = threading.Lock()  # two pipelines on two threads build and load once
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list[str]:
    """The headers every source may include: csrc/*.cuh and the trig
    copies that native/ shares with the host (native/trig.h)."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [TRIG_HEADER]


def library_path(src: str) -> str:
    """The library built from ``src``: its name carries a hash of the
    flags, the source and every shared header (``headers()``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *headers()):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
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
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
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
    """The entry points of every kernel library, built at first call (once,
    under a lock; a launch reads the loaded object without taking it)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load() -> types.SimpleNamespace:
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
    return types.SimpleNamespace(**fns)


# raw_stream(index): the raw pointer of PyTorch's current stream on CUDA
# device ``index``. It follows ``torch.cuda.stream(...)`` contexts and
# builds no Python object, where ``torch.cuda.current_stream(device)
# .cuda_stream`` builds a Stream on every call (None in a CPU-only build).
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device) -> int:
    """``raw_stream`` of a CUDA ``device``."""
    index = device.index
    return raw_stream(torch.cuda.current_device() if index is None else index)


def expect(name: str, device, dtype, **tensors) -> None:
    """Raise ValueError unless every tensor is contiguous, of ``dtype`` and
    on ``device``. A wrapper hands the kernel its inputs as they are: it
    converts and copies nothing, so what the kernel cannot read is an
    error of the caller."""
    for label, t in tensors.items():
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} tensor on {device}; "
                             f"got {t.dtype} with strides {tuple(t.stride())} on {t.device}")


def expect_shape(name: str, **shapes) -> None:
    """Raise ValueError unless each ``label=(tensor, shape)`` has that shape."""
    for label, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {shape}")


def expect_origin(name: str, device, rays_o, R: int) -> int:
    """Raise ValueError unless ``rays_o`` is (R, 3) f32 rows on ``device``
    with a row stride of 3, or of 0 (one origin expanded to every ray, as
    the trackers pass it); return that row stride (3 where R <= 1)."""
    ok = (rays_o.dtype == torch.float32 and rays_o.device == device
          and tuple(rays_o.shape) == (R, 3) and rays_o.stride(1) == 1)
    stride = rays_o.stride(0) if ok and R > 1 else 3
    if not ok or stride not in (0, 3):
        raise ValueError(f"{name}: rays_o must be ({R}, 3) f32 rows on {device} (row stride 3, or "
                         f"0 for one shared origin); got {tuple(rays_o.shape)} {rays_o.dtype}, "
                         f"strides {tuple(rays_o.stride())}, on {rays_o.device}")
    return stride


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
