"""Offline ScanNet data preparation: raw meshes -> per-scene .npz archives
(the port of pcf_tpu/data/prepare.py: archives of the same contents).

Rebuild of data_preparation/prepare_data.py: reads `scene*_vh_clean_2.ply`
(colored mesh) and the matching `_vh_clean_2.labels.ply`, computes vertex
normals (area-weighted face normals — the reference used open3d's
ComputeVertexNormals, prepare_data.py:13-22; this is the same algorithm
without the dependency), remaps the raw NYU40-style labels to the 20
ScanNet-benchmark classes with -100 ignore (prepare_data.py:73-75), and
writes coords/feats(color+normal)/labels per scene with multiprocessing.

Usage: python -m pcf_torch.data.prepare <scans_dir> <split> <out_dir>
  with split lists scannetv2_{train,val,test}.txt next to <scans_dir> or in cwd.
"""

from __future__ import annotations

import multiprocessing
import os
import sys

import numpy as np

# raw label id -> 0..19 benchmark class (NYU40 ids of the 20 classes);
# everything else is ignore (-100)  [prepare_data.py:73-75]
VALID_CLASS_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                   34, 36, 39]
REMAPPER = np.full(150, -100, dtype=np.int64)
for i, c in enumerate(VALID_CLASS_IDS):
    REMAPPER[c] = i


def read_ply_mesh(path: str):
    """Minimal binary/ascii PLY reader for ScanNet meshes: returns
    (vertices [N,3] f32, colors [N,3] f32 or None, labels [N] or None,
    faces [F,3] i32 or None)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header_lines if l.startswith("format")).split()[1]
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        binary = fmt.startswith("binary")

        elems = []  # (name, count, [(type, prop)])
        for line in header_lines:
            parts = line.split()
            if parts[0] == "element":
                elems.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elems[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elems[-1][2].append((parts[1], parts[2]))

        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "char": "i1",
                    "short": "<i2", "ushort": "<u2", "int": "<i4",
                    "int32": "<i4", "uint": "<u4", "uint16": "<u2"}

        verts = colors = labels = faces = None
        for name, count, props in elems:
            if name == "vertex":
                dtype = np.dtype([(p[1], type_map[p[0]]) for p in props])
                if binary:
                    rec = np.frombuffer(f.read(count * dtype.itemsize),
                                        dtype=dtype, count=count)
                else:
                    rows = [f.readline().split() for _ in range(count)]
                    rec = np.array([tuple(r[: len(props)]) for r in rows],
                                   dtype=dtype)
                verts = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float32)
                if "red" in dtype.names:
                    colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                                      1).astype(np.float32)
                if "label" in dtype.names:
                    labels = rec["label"].astype(np.int64)
            elif name == "face":
                if binary:
                    out = np.empty((count, 3), np.int32)
                    cnt_t = type_map[props[0][1]]
                    idx_t = type_map[props[0][2]]
                    cnt_size = np.dtype(cnt_t).itemsize
                    idx_size = np.dtype(idx_t).itemsize
                    buf = f.read(count * (cnt_size + 3 * idx_size))
                    stride = cnt_size + 3 * idx_size
                    for i in range(count):
                        off = i * stride
                        out[i] = np.frombuffer(
                            buf[off + cnt_size: off + stride], dtype=idx_t)
                    faces = out
                else:
                    faces = np.array(
                        [f.readline().split()[1:4] for _ in range(count)],
                        dtype=np.int32)
        return verts, colors, labels, faces


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals from triangle faces."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # length == 2*area -> area weighting
    normals = np.zeros_like(verts)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def process_scene(scans_dir: str, scene: str, out_dir: str, with_labels: bool = True):
    mesh_path = os.path.join(scans_dir, scene, f"{scene}_vh_clean_2.ply")
    verts, colors, _, faces = read_ply_mesh(mesh_path)
    normals = compute_vertex_normals(verts, faces)
    coords = np.ascontiguousarray(verts - verts.mean(0))
    colors = colors / 127.5 - 1.0  # [0,255] -> [-1,1] (prepare_data.py convention)

    labels = np.full(coords.shape[0], -100, np.int64)
    if with_labels:
        lbl_path = os.path.join(scans_dir, scene,
                                f"{scene}_vh_clean_2.labels.ply")
        if os.path.exists(lbl_path):
            _, _, raw, _ = read_ply_mesh(lbl_path)
            labels = REMAPPER[np.clip(raw, 0, 149)]

    feats = np.concatenate([colors.astype(np.float32), normals], 1)
    np.savez_compressed(os.path.join(out_dir, f"{scene}.npz"),
                        coords=coords.astype(np.float32), feats=feats,
                        labels=labels, name=scene)
    return scene


def main(scans_dir: str, split: str, out_dir: str, num_workers: int = 8):
    list_file = f"scannetv2_{split}.txt"
    for cand in (list_file, os.path.join(os.path.dirname(scans_dir), list_file)):
        if os.path.exists(cand):
            list_file = cand
            break
    with open(list_file) as f:
        scenes = [l.strip() for l in f if l.strip()]
    os.makedirs(out_dir, exist_ok=True)
    with_labels = split != "test"
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        for s in pool.starmap(
                process_scene,
                [(scans_dir, sc, out_dir, with_labels) for sc in scenes]):
            print("done", s)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "./prepared")
