"""The port's host-native library (nerfloam_tpu_torch/native) against the
JAX package's (nerfloam_tpu/native): the same C++ source built by g++ with
the same flags gives np.array_equal range-filter rows, ground masks and
cosines on seeded clouds of 20k and 133k points and on edge cases, and the
port's LidarDataset.__getitem__ (kitti, maicity, ncd) equals the JAX
package's default (native) path on files written here. A failed build
raises (there is no numpy fallback), and threads that load the library at
once build and load it once."""

import ctypes
import os
import threading

import numpy as np
import pytest

from nerfloam_tpu import native as jnative
from nerfloam_tpu.data import kitti as jkitti
from nerfloam_tpu.data import maicity as jmaicity
from nerfloam_tpu.data import ncd as jncd
from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch import native
from nerfloam_tpu_torch.data import kitti as tkitti
from nerfloam_tpu_torch.data import maicity as tmaicity
from nerfloam_tpu_torch.data import ncd as tncd

from test_torch_data import _cloud

SENSOR_HEIGHT = 1.7  # segment_ground's default


@pytest.fixture(scope="module", autouse=True)
def jax_lib():
    assert jnative.get_lib() is not None, "the JAX package's native library did not build"


def _ring_sector_edges():
    """Points on every ring boundary (the log-spaced radii, and the range
    clamps 1 and 80 m) at every sector edge, a few heights each."""
    radii = np.exp(np.log(1.0) + np.arange(9) / 8 * (np.log(80.0) - np.log(1.0)))
    radii = np.concatenate([radii, [0.5, 1.0, 80.0, 120.0]])
    angles = -np.pi + np.arange(17) * (2 * np.pi / 16)
    r, a, z = np.meshgrid(radii, angles, np.linspace(-1.8, -1.6, 10), indexing="ij")
    pts = np.stack([r * np.cos(a), r * np.sin(a), z], -1).reshape(-1, 3)
    axes = np.array([[1.0, 0, -1.7], [0, 1.0, -1.7], [-1.0, 0, -1.7], [0, -1.0, -1.7],
                     [80.0, 0, -1.7], [-80.0, 0, -1.7], [0, 0, -1.7]])
    return np.concatenate([pts, axes]).astype(np.float32)


def _sparse_cells():
    """Seven points, one short of a segmented cell, in each of the 8 x 16
    cells (rings log-spaced over 1-80 m, 16 sectors)."""
    rng = np.random.default_rng(5)
    ring = (np.arange(8) + 0.5) / 8
    r = np.exp(ring * np.log(80.0))[:, None, None] * rng.uniform(0.97, 1.03, (8, 16, 7))
    a = (-np.pi + (np.arange(16) + 0.5) * (2 * np.pi / 16))[None, :, None] + rng.uniform(
        -0.05, 0.05, (8, 16, 7))
    z = rng.normal(-SENSOR_HEIGHT, 0.02, (8, 16, 7))
    return np.stack([r * np.cos(a), r * np.sin(a), z], -1).reshape(-1, 3).astype(np.float32)


def _low_seeds():
    """One cell whose lowest 15% lie under -sensor_height - 1.5 (no seed
    passes the floor), one beside it that seeds normally."""
    rng = np.random.default_rng(6)
    out = []
    for az, low in ((0.1, True), (0.5, False)):
        r = rng.uniform(10, 12, 60)
        a = az + rng.uniform(-0.05, 0.05, 60)
        z = rng.normal(-SENSOR_HEIGHT, 0.02, 60)
        if low:
            z[:15] = -SENSOR_HEIGHT - 2.0 + rng.normal(0, 0.01, 15)
        out.append(np.stack([r * np.cos(a), r * np.sin(a), z], -1))
    return np.concatenate(out).astype(np.float32)


CLOUDS = {
    "cloud_20k": lambda: _cloud(0)[:, :3],
    "cloud_133k": lambda: _cloud(2, n=100000)[:, :3],
    "empty": lambda: np.zeros((0, 3), np.float32),
    "sparse_cells": _sparse_cells,
    "low_seeds": _low_seeds,
    "ring_sector_edges": _ring_sector_edges,
}


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_segment_ground_bit_equal_to_jax(name):
    pts = CLOUDS[name]()
    jm, jc = jnative.segment_ground_native(pts)
    tm, tc = native.segment_ground_native(pts)
    assert tm.dtype == jm.dtype and tc.dtype == jc.dtype == np.float32
    assert tm.shape == tc.shape == (len(pts),)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    if name.startswith("cloud"):
        assert 0.3 < tm.mean() < 0.95 and (tc[tm] < 1).all()
    if name in ("empty", "sparse_cells"):  # no cell reaches 8 points
        assert not tm.any() and (tc == 1).all()
    if name == "low_seeds":  # the low cell is skipped, its neighbour segmented
        assert not tm[:60].any() and tm[60:].mean() > 0.8


def _range_edges(stride):
    """Rows on the z cutoff and on both range bounds, and rows beside them."""
    rows = [[0, 0, -3.0], [0, 0, -2.999], [2.0, 0, 0], [2.0001, 0, 0], [0, 40.0, 0],
            [0, 39.999, 0], [0, 0, 40.0], [3.0, 3.0, 3.0], [30.0, 20.0, -2.5], [-40.0, 0, 0]]
    out = np.zeros((len(rows), stride), np.float32)
    out[:, :3] = rows
    return out


SCANS = {
    "cloud_20k_stride4": lambda: _cloud(1),
    "cloud_133k_stride4": lambda: _cloud(2, n=100000),
    "cloud_20k_stride3": lambda: np.ascontiguousarray(_cloud(1)[:, :3]),
    "empty_stride4": lambda: np.zeros((0, 4), np.float32),
    "edges_stride4": lambda: _range_edges(4),
    "edges_stride3": lambda: _range_edges(3),
}
BOUNDS = {"kitti": (-3.0, 2.0, 40.0), "none": (-np.inf, -1.0, -1.0), "max_only": (-np.inf, -1.0, 40.0)}


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_filter_scan_bit_equal_to_jax(scan, bounds):
    raw = SCANS[scan]()
    z_min, min_d, max_d = BOUNDS[bounds]
    ref = jnative.filter_scan_native(raw, z_min, min_d, max_d)
    out = native.filter_scan_native(raw, z_min, min_d, max_d)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    if scan.startswith("edges") and bounds == "kitti":
        # open bounds: z on the cutoff and |p| on either bound are dropped
        np.testing.assert_array_equal(out, raw[[1, 3, 5, 7, 8], :3])


def _write_pcd(path, pts):
    header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(pts)}\n"
              "DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(pts, np.float32).tobytes())


def _poses(n):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 0, 3] = np.arange(n) * 0.7
    return T[:, :3, :].reshape(n, 12)


LOADERS = {  # name: (JAX module, port module, directory, file name, depth limits)
    "kitti": (jkitti, tkitti, "velodyne", "{:06d}.bin", (40.0, 2.0)),
    "maicity": (jmaicity, tmaicity, "velodyne", "{:05d}.bin", (-1, -1)),
    "ncd": (jncd, tncd, "pcd", "{:05d}.pcd", (30.0, 1.0)),
}


@pytest.mark.parametrize("use_gt", [False, True])
@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_getitem_equal_to_jax(tmp_path, name, use_gt):
    jmod, tmod, sub, fname, (max_d, min_d) = LOADERS[name]
    (tmp_path / sub).mkdir()
    offset = 500 if name == "ncd" else 0
    for i in range(2):
        raw = _cloud(10 + i)
        path = tmp_path / sub / fname.format(i + offset)
        if name == "ncd":
            _write_pcd(path, raw[:, :3])
        else:
            raw.tofile(path)
    np.savetxt(tmp_path / tmod.DataLoader.pose_file, _poses(2))
    jds = jmod.DataLoader(str(tmp_path), use_gt=use_gt, max_depth=max_d, min_depth=min_d)
    tds = tmod.DataLoader(str(tmp_path), use_gt=use_gt, max_depth=max_d, min_depth=min_d)
    assert len(tds) == len(jds) == 2
    np.testing.assert_array_equal(tds.get_init_pose(1), jds.get_init_pose(1))
    for i in range(2):
        ji, jp, jc, jpose = jds[i]
        ti, tp, tc, tpose = tds[i]
        assert ti == ji == i
        assert tp.dtype == jp.dtype == np.float32 and tc.dtype == jc.dtype == np.float32
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
        if use_gt:
            np.testing.assert_array_equal(tpose, jpose)
        else:
            assert tpose is None and jpose is None
        assert 0 < len(tp) <= len(_cloud(10 + i)) and (tc < 1).any()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.build()
    assert not os.listdir(tmp_path / "build")
    # the loader's own path: no library, and no numpy fallback either
    with pytest.raises(RuntimeError, match="native build failed"):
        native.segment_ground_native(_cloud(0)[:, :3])
    (tmp_path / "velodyne").mkdir()
    _cloud(0).tofile(tmp_path / "velodyne" / "000000.bin")
    with pytest.raises(RuntimeError, match="native build failed"):
        tkitti.DataLoader(str(tmp_path))[0]


def test_compiler_error_names_command_and_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError) as e:
        native.build()
    assert "bad.cpp" in str(e.value) and "error" in str(e.value)
    assert not os.listdir(tmp_path / "build")


def test_library_name_follows_compiler_and_target(tmp_path, monkeypatch):
    """A library built for one host's CPU or by one compiler version is not
    the one another host or version loads: the name hashes both."""
    names = []
    for version, march in (("12.2.0", "skylake-avx512"), ("12.2.0", "znver4"),
                           ("13.1.0", "skylake-avx512")):
        fake = tmp_path / f"g++-{version}-{march}"
        fake.write_text("#!/bin/sh\ncase \"$*\" in\n"
                        f"  *--version*) echo 'g++ {version}';;\n"
                        f"  *--help=target*) echo '  -march=   {march}';;\n"
                        "esac\n")
        fake.chmod(0o755)
        monkeypatch.setattr(native, "CXX", str(fake))
        names.append(os.path.basename(native.library_path()))
    monkeypatch.undo()
    names.append(os.path.basename(native.library_path()))
    assert len(set(names)) == 4, names


def test_threads_build_and_load_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    runs, real_run = [], native.subprocess.run

    def counted_run(cmd, **kw):
        runs.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted_run)
    n = 4
    barrier, got = threading.Barrier(n, timeout=60), [None] * n

    def load(i):
        barrier.wait()
        got[i] = native.get_lib()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(isinstance(g, ctypes.CDLL) for g in got) and all(g is got[0] for g in got)
    compiles = [c for c in runs if "-o" in c]  # the others ask the compiler who it is
    assert len(compiles) == 1
    assert os.listdir(tmp_path / "build") == [os.path.basename(native.library_path())]
    # a second call loads nothing new and asks nothing more
    n_runs = len(runs)
    assert native.get_lib() is got[0] and len(runs) == n_runs


def test_kernel_library_loaded_once_across_threads(monkeypatch):
    """kernels.lib(): two pipelines on two threads must not both build."""
    monkeypatch.setattr(kernels, "_lib", None)
    loads = []
    started = threading.Event()

    def slow_load():
        loads.append(threading.get_ident())
        started.set()
        threading.Event().wait(0.2)  # hold the lock while the others arrive
        return object()

    monkeypatch.setattr(kernels, "_load", slow_load)
    got = [None] * 4

    def call(i):
        got[i] = kernels.lib()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and started.is_set()
    assert all(g is got[0] for g in got) and got[0] is not None
