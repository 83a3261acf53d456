"""Minimal PCD reader (ASCII, binary, binary_compressed), pure numpy.

Copy of nerfloam_tpu/data/pcd_io.py (numpy only): the port imports nothing
of the JAX package.

The reference reads Newer College .pcd files through open3d
(NeRF-LOAM src/dataset/ncd.py:50-52); open3d is not a dependency of
this framework, so we parse the PCD v0.7 format directly — including the
``binary_compressed`` mode common in real NCD dumps (LZF-compressed,
field-major layout; see pcl/io/lzf.cpp for the stream format).
"""

from __future__ import annotations

import struct

import numpy as np


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Pure-python libLZF decompression (the PCL PCD codec).

    Stream grammar: a control byte < 32 starts a literal run of (ctrl + 1)
    bytes; otherwise it encodes a back-reference of length (ctrl >> 5) + 2
    (plus an extension byte when the 3-bit length field saturates at 7) at
    distance (((ctrl & 0x1f) << 8) | next_byte) + 1.
    """
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            if i + run > n:
                raise ValueError("corrupt LZF stream: truncated literal run")
            out[o : o + run] = data[i : i + run]
            i += run
            o += run
        else:  # back reference into the output window
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise ValueError(
                        "corrupt LZF stream: truncated length extension"
                    )
                length += data[i]
                i += 1
            length += 2
            if i >= n:
                raise ValueError(
                    "corrupt LZF stream: truncated back-reference offset"
                )
            ref = o - (((ctrl & 0x1F) << 8) | data[i]) - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: reference before start")
            if o - ref >= length:  # non-overlapping: bulk copy
                out[o : o + length] = out[ref : ref + length]
                o += length
            else:  # overlapping: byte-by-byte (RLE-style)
                for _ in range(length):
                    out[o] = out[ref]
                    o += 1
                    ref += 1
    if o != expected_size:
        raise ValueError(
            f"corrupt LZF stream: decompressed {o} bytes, expected {expected_size}"
        )
    return bytes(out)


def read_pcd(path: str) -> np.ndarray:
    """Returns (N, 3) float32 xyz points."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(x) for x in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(x) for x in rest.split()]
            elif key == "POINTS":
                n_points = int(rest)
            elif key == "DATA":
                data_mode = rest.strip().lower()
                break
        if not counts:
            counts = [1] * len(fields)
        np_types = {"F": "f", "I": "i", "U": "u"}
        dt = np.dtype(
            [
                (name, f"{np_types[t]}{s}", (c,) if c > 1 else ())
                for name, s, t, c in zip(fields, sizes, types, counts)
            ]
        )
        if data_mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            idx = {name: i for i, name in enumerate(fields)}
            xyz = rows[:, [idx["x"], idx["y"], idx["z"]]]
        elif data_mode == "binary":
            rec = np.fromfile(f, dt, n_points)
            xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1)
        elif data_mode == "binary_compressed":
            # u32 compressed size, u32 uncompressed size, LZF blob; the
            # decompressed buffer is FIELD-MAJOR (all x, then all y, ...)
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = lzf_decompress(f.read(comp_size), uncomp_size)
            cols = {}
            off = 0
            for name, s, t, c in zip(fields, sizes, types, counts):
                width = s * c * n_points
                col = np.frombuffer(
                    raw[off : off + width], dtype=f"{np_types[t]}{s}"
                )
                cols[name] = col.reshape(n_points, c) if c > 1 else col
                off += width
            xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
        else:
            raise ValueError(f"unknown PCD data mode {data_mode}")
    xyz = xyz.astype(np.float32)
    return xyz[np.all(np.isfinite(xyz), axis=-1)]
