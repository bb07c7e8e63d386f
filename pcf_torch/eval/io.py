"""Evaluation output writers: colored PLY, per-scene label txt, prob npy
(the port of pcf_tpu/eval/io.py: the same bytes).

Replaces the reference's open3d-based writers (test_ScanNet_simple.py:180-232)
with a dependency-free ASCII/binary PLY writer. Colormap + 20->40 class
remapping follow the NYU40 convention (test_ScanNet_simple.py:235-278).
"""

from __future__ import annotations

import numpy as np

# NYU40 RGB colormap (the standard ScanNet benchmark palette)
NYU40_COLORMAP = [
    (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40), (197, 176, 213),
    (148, 103, 189), (196, 156, 148), (23, 190, 207), (178, 76, 76), (247, 182, 210),
    (66, 188, 102), (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
    (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229), (100, 125, 154),
    (178, 127, 135), (120, 185, 128), (146, 111, 194), (44, 160, 44), (112, 128, 144),
    (96, 207, 209), (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144),
]

# ScanNet's 20 training classes -> NYU40 ids (test_ScanNet_simple.py:235-249)
REMAP_20_TO_40 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]


def remap_20_to_nyu40(labels20: np.ndarray) -> np.ndarray:
    table = np.asarray(REMAP_20_TO_40, dtype=np.int32)
    out = np.zeros_like(labels20, dtype=np.int32)
    valid = (labels20 >= 0) & (labels20 < 20)
    out[valid] = table[labels20[valid]]
    return out


def write_ply_color(path: str, points: np.ndarray, labels20: np.ndarray,
                    binary: bool = True):
    """Write a point cloud colored by predicted class (NYU40 palette)."""
    nyu = remap_20_to_nyu40(labels20)
    colors = np.asarray(NYU40_COLORMAP, dtype=np.uint8)[np.clip(nyu, 0, 40)]
    n = points.shape[0]
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary else "format ascii 1.0\n")
        + f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    if binary:
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = points.astype(np.float32)
        rec["rgb"] = colors
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def read_ply(path: str):
    """Minimal PLY reader for round-tripping our own files (tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        head = header.decode("ascii")
        n = int([l for l in head.splitlines() if l.startswith("element vertex")][0].split()[-1])
        binary = "binary" in head
        if binary:
            rec = np.frombuffer(f.read(), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                                count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts, cols = [], []
        for _ in range(n):
            vals = f.readline().split()
            pts.append([float(v) for v in vals[:3]])
            cols.append([int(v) for v in vals[3:6]])
        return np.asarray(pts, np.float32), np.asarray(cols, np.uint8)


def write_labels_txt(path: str, labels20: np.ndarray):
    """Benchmark-format per-point NYU40 labels (test_ScanNet_simple.py:224-228)."""
    np.savetxt(path, remap_20_to_nyu40(labels20), fmt="%d")
