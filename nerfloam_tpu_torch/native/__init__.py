"""The port's host-native code (C++ via ctypes): the range filter and the
ground segmenter that every file-based loader runs (``data/base.py``), the
counterpart of nerfloam_tpu/native/__init__.py, and the host copies of
sinf, cosf and atan2f (``trig.cpp`` over ``trig.h``) that ``ops/trig.py``
runs on CPU tensors.

``ground_seg.cpp`` is compiled by g++ with the JAX package's flags at first
use, into a shared library under ``native/build/`` (listed in .gitignore)
whose file name carries a hash of the source, the flags, the compiler's
version and the target ``-march=native`` selects on this host; nothing is
built at import. The build runs under a lock, so that two loader threads
build it once, and writes a temporary file of its own before renaming it,
so that two processes building at once each leave a whole library.

``trig.cpp`` is its own library (``trig_library_path``, ``get_trig_lib``),
built the same way with ``TRIG_FLAGS``: the JAX package's flags, which let
g++ contract products into FMAs in C++ modes, plus ``-ffp-contract=off``,
so that only the fused operations ``trig.h`` writes are fused.

There is no numpy fallback: a build or load that fails raises, naming the
command and the compiler's output. ``data/ground.segment_ground`` and
``LidarDataset.filter_scan`` stay as the plain twins the tests hold this
library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "ground_seg.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
CXX = "g++"
# the JAX package's flags (nerfloam_tpu/native/__init__.py), so both
# libraries round alike (g++ may contract a * b + c into an FMA in C++ modes,
# in both)
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
TRIG_SRC = os.path.join(_HERE, "trig.cpp")
TRIG_HEADER = os.path.join(_HERE, "trig.h")
TRIG_FLAGS = [*CXX_FLAGS, "-ffp-contract=off"]

_F = ctypes.POINTER(ctypes.c_float)
_V = ctypes.c_void_p
_L = ctypes.c_long
_SIGNATURES = {
    "segment_ground": [_F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8), _F],
    "filter_scan": [_F, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.c_float, _F],
}

_TRIG_SIGNATURES = {
    "nl_sinf_n": [_V, _L, _V],
    "nl_cosf_n": [_V, _L, _V],
    "nl_atan2f_n": [_V, _V, _L, _V],
}

_lock = threading.Lock()
_lib = None
_trig_lib = None


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str, flags: tuple) -> bytes:
    """What ``cxx`` with ``flags`` builds for on this host: its version and
    the target options the flags select (``-march=native`` resolves to this
    CPU's), so that a build directory carried to another host or compiler
    is not reused there."""
    out = b""
    for cmd in ([cxx, "--version"], [cxx, *flags, "-Q", "--help=target"]):
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout.decode()}{proc.stderr.decode()}")
        out += proc.stdout
    return out


def _hashed_path(stem: str, flags: list, files: tuple) -> str:
    """``BUILD_DIR/lib<stem>_<hash>.so``: the hash covers the compiler, its
    version, the flags, the target they select on this host and ``files``."""
    h = hashlib.sha256(" ".join([CXX, *flags]).encode())
    h.update(_compiler_id(CXX, tuple(flags)))
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    """The library built from ``SRC`` by ``CXX`` into ``BUILD_DIR``: its
    name carries a hash of the compiler, its version, the flags, the target
    they select on this host and the source."""
    return _hashed_path("ground_seg", CXX_FLAGS, (SRC,))


def trig_library_path() -> str:
    """The library built from ``TRIG_SRC`` with ``TRIG_FLAGS``; its name
    hashes ``trig.h`` too."""
    return _hashed_path("trig", TRIG_FLAGS, (TRIG_SRC, TRIG_HEADER))


def _compile(src: str, flags: list, path: str) -> str:
    """Compile ``src`` into ``path`` unless it exists; return ``path``.
    Raises RuntimeError with the command and the compiler's output if the
    compiler fails or cannot be started."""
    if os.path.exists(path):
        return path
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *flags, src, "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build() -> str:
    """Compile ``SRC`` unless its hashed library exists; return its path.
    Raises RuntimeError with the command and the compiler's output if the
    compiler fails or cannot be started."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return _compile(SRC, CXX_FLAGS, library_path())


def build_trig() -> str:
    """Compile ``TRIG_SRC`` unless its hashed library exists; its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return _compile(TRIG_SRC, TRIG_FLAGS, trig_library_path())


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first call (once, under a lock)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def get_trig_lib() -> ctypes.CDLL:
    """The loaded trig library, built at first call (once, under a lock)."""
    global _trig_lib
    if _trig_lib is None:
        with _lock:
            if _trig_lib is None:
                lib = ctypes.CDLL(build_trig())
                for name, argtypes in _TRIG_SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _trig_lib = lib
    return _trig_lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def segment_ground_native(
    points: np.ndarray,
    n_rings: int = 8,
    n_sectors: int = 16,
    min_range: float = 1.0,
    max_range: float = 80.0,
    seed_quantile: float = 0.15,
    dist_th: float = 0.2,
    uprightness_th: float = 0.85,
    n_iters: int = 3,
    sensor_height: float = 1.7,
):
    """C++ ground segmentation; the contract of data.ground.segment_ground:
    (ground mask (N,) bool, cosines (N,) f32, 1 off the ground)."""
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"segment_ground_native: points must be (N, >=3), got {points.shape}")
    lib = get_lib()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = len(pts)
    mask = np.zeros(n, np.uint8)
    cos = np.ones(n, np.float32)
    lib.segment_ground(
        _fptr(pts), n, n_rings, n_sectors, min_range, max_range,
        seed_quantile, dist_th, uprightness_th, n_iters, sensor_height,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(cos),
    )
    return mask.astype(bool), cos


def filter_scan_native(xyzr: np.ndarray, z_min: float, min_d: float, max_d: float):
    """C++ z cutoff and range ball on an (N, >=3) scan: the (M, 3) f32 rows
    with z > z_min and min_d < |p| < max_d (a bound <= 0 is off)."""
    if xyzr.ndim != 2 or xyzr.shape[1] < 3:
        raise ValueError(f"filter_scan_native: xyzr must be (N, >=3), got {xyzr.shape}")
    lib = get_lib()
    arr = np.ascontiguousarray(xyzr, np.float32)
    n, stride = arr.shape[0], arr.shape[1]
    out = np.empty((n, 3), np.float32)
    k = lib.filter_scan(_fptr(arr), n, stride, z_min, min_d, max_d, _fptr(out))
    return out[:k].copy()
