"""Synthetic rooms made in memory from a seed: the benchmark's inputs.

`make_room` is a frozen copy of tools/make_synth_dataset.py's generator as
the benchmark was written (floor, ceiling and four walls as noisy planes,
five to nine furniture boxes, class-correlated colours, true face normals),
with one change: furniture classes are drawn from 3 .. num_classes - 1
(the shipped generator knows 8 classes), each class's box size taken from
the five shipped priors in turn and its colour from a fixed palette, so
that a 20-class model sees every class.

`level0` turns a raw room into what a scene contributes to a batch: z
shifted to the floor, the minimum corner moved to the origin, and one point
kept per voxel of the finest grid (the first in the room's own order).
"""

from __future__ import annotations

import numpy as np

_BASE_PALETTE = np.array([
    [0.85, 0.85, 0.80], [0.45, 0.30, 0.20], [0.95, 0.95, 0.95], [0.20, 0.45, 0.70],
    [0.70, 0.20, 0.20], [0.20, 0.60, 0.30], [0.60, 0.55, 0.15], [0.50, 0.25, 0.55],
], np.float32)
_SIZE_PRIOR = [(1.2, 0.8, 0.75), (0.5, 0.5, 0.9), (1.8, 0.9, 0.8), (0.9, 0.5, 1.6),
               (0.4, 0.4, 0.4)]


def palette(num_classes: int) -> np.ndarray:
    """The shipped eight colours, then fixed colours for classes 8 and up."""
    extra = np.random.default_rng(12345).uniform(0.1, 0.9, (max(num_classes - 8, 0), 3))
    return np.concatenate([_BASE_PALETTE, extra.astype(np.float32)])[:num_classes]


def _plane(rng, n, origin, u, v, normal, cls):
    a = rng.uniform(0, 1, (n, 1))
    b = rng.uniform(0, 1, (n, 1))
    pts = origin + a * u + b * v + rng.normal(0, 0.004, (n, 3))
    nrm = np.tile(normal / np.linalg.norm(normal), (n, 1))
    return pts, nrm, np.full(n, cls, np.int64)


def _box(rng, n_per_face, center, size, cls, yaw):
    cx, cy, cz = center
    sx, sy, sz = size
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                  [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
    faces = [((-sx / 2, -sy / 2, sz), (sx, 0, 0), (0, sy, 0), (0, 0, 1)),
             ((-sx / 2, -sy / 2, 0), (sx, 0, 0), (0, 0, sz), (0, -1, 0)),
             ((-sx / 2, sy / 2, 0), (sx, 0, 0), (0, 0, sz), (0, 1, 0)),
             ((-sx / 2, -sy / 2, 0), (0, sy, 0), (0, 0, sz), (-1, 0, 0)),
             ((sx / 2, -sy / 2, 0), (0, sy, 0), (0, 0, sz), (1, 0, 0))]
    pts_all, nrm_all, lab_all = [], [], []
    for origin, u, v, nrm in faces:
        p, m, lab = _plane(rng, n_per_face, np.array(origin, np.float32),
                           np.array(u, np.float32), np.array(v, np.float32),
                           np.array(nrm, np.float32), cls)
        pts_all.append(p)
        nrm_all.append(m)
        lab_all.append(lab)
    pts = np.concatenate(pts_all) @ R.T + np.array([cx, cy, cz], np.float32)
    return (pts.astype(np.float32), (np.concatenate(nrm_all) @ R.T).astype(np.float32),
            np.concatenate(lab_all))


def make_room(seed: int, n_points: int, num_classes: int = 8):
    """(coord [N, 3], colour [N, 3], normal [N, 3], label [N]) of one room."""
    rng = np.random.default_rng(seed)
    W, D, H = rng.uniform(4.5, 8.0), rng.uniform(4.5, 8.0), rng.uniform(2.4, 3.2)
    surfaces = [((0, 0, 0), (W, 0, 0), (0, D, 0), (0, 0, 1), 1, W * D),
                ((0, 0, H), (W, 0, 0), (0, D, 0), (0, 0, -1), 2, W * D),
                ((0, 0, 0), (W, 0, 0), (0, 0, H), (0, 1, 0), 0, W * H),
                ((0, D, 0), (W, 0, 0), (0, 0, H), (0, -1, 0), 0, W * H),
                ((0, 0, 0), (0, D, 0), (0, 0, H), (1, 0, 0), 0, D * H),
                ((W, 0, 0), (0, D, 0), (0, 0, H), (-1, 0, 0), 0, D * H)]
    total_area = sum(s[-1] for s in surfaces)
    room_pts = int(n_points * 0.62)
    pts_list, nrm_list, lab_list = [], [], []
    for origin, u, v, nrm, cls, area in surfaces:
        n = max(64, int(room_pts * area / total_area))
        p, m, lab = _plane(rng, n, np.array(origin, np.float32), np.array(u, np.float32),
                           np.array(v, np.float32), np.array(nrm, np.float32), cls)
        pts_list.append(p)
        nrm_list.append(m)
        lab_list.append(lab)
    n_boxes = rng.integers(5, 10)
    box_pts = (n_points - room_pts) // max(n_boxes, 1)
    for _ in range(n_boxes):
        cls = int(rng.integers(3, num_classes))
        base = np.array(_SIZE_PRIOR[(cls - 3) % len(_SIZE_PRIOR)], np.float32)
        size = base * rng.uniform(0.7, 1.3, 3).astype(np.float32)
        center = (rng.uniform(0.5, W - 0.5), rng.uniform(0.5, D - 0.5), 0.0)
        p, m, lab = _box(rng, max(16, box_pts // 5), center, size, cls,
                         yaw=rng.uniform(0, np.pi))
        pts_list.append(p)
        nrm_list.append(m)
        lab_list.append(lab)
    coord = np.concatenate(pts_list).astype(np.float32)
    norm = np.concatenate(nrm_list).astype(np.float32)
    label = np.concatenate(lab_list)
    color = palette(num_classes)[label] + rng.normal(0, 0.06, (label.size, 3))
    color = np.clip(color, 0, 1).astype(np.float32)
    perm = rng.permutation(coord.shape[0])
    return coord[perm], color[perm], norm[perm], label[perm]


def level0(coord, color, norm, label, grid0: float):
    """The room as a scene: z from the floor, the minimum corner at the
    origin, the first point of each grid0 voxel."""
    coord = coord.astype(np.float32).copy()
    coord[:, 2] -= coord[:, 2].min()
    coord -= coord.min(0)
    cell = np.floor(coord / grid0).astype(np.int64)
    _, first = np.unique(cell, axis=0, return_index=True)
    keep = np.sort(first)
    return (coord[keep], color[keep].astype(np.float32), norm[keep].astype(np.float32),
            label[keep].astype(np.int32))
