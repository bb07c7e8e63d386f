"""Host-side multi-resolution pyramid: per-scene grid subsampling
and the three kNN edge sets per level, the port of pcf_tpu/data/pyramid.py.

Grid subsampling and kNN run in the native C++ library (pcf_torch/native)
where g++ builds it, else in numpy and scipy's cKDTree; PCF_NO_NATIVE=1 in
the environment forces the numpy/scipy path. The two give the same voxels,
in another order, and may break kNN ties differently. The choice is made at
first use (use_native) and kept in the module flag _USE_NATIVE, which a
caller may set beforehand.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree

from pcf_torch import native as native_lib
from pcf_torch.ops.subsample import grid_subsampling as _np_grid_subsampling
from pcf_torch.ops.window import morton_argsort

_USE_NATIVE: bool | None = None  # None: decided at the first use_native()


def use_native() -> bool:
    """Whether the pyramid takes the native library: unless PCF_NO_NATIVE=1,
    where g++ exists (this builds the library, or raises if its build
    fails). Decided once per process, unless _USE_NATIVE was set."""
    global _USE_NATIVE
    if _USE_NATIVE is None:
        _USE_NATIVE = os.environ.get("PCF_NO_NATIVE") != "1" and native_lib.is_available()
    return _USE_NATIVE


def grid_subsampling(points, features=None, labels=None, sampleDl=0.1):
    """Voxel-barycenter subsampling: the native library's, or numpy's
    (ops/subsample.py); the same voxels, up to their order."""
    if use_native():
        return native_lib.grid_subsample(points, features, labels, sampleDl)
    return _np_grid_subsampling(points, features, labels, sampleDl)


def compute_knn(
    ref_points: np.ndarray,
    query_points: np.ndarray,
    K: int,
    dilated_rate: int = 1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """K nearest neighbors of each query among refs. With dilated_rate > 1
    selects every dilated_rate-th of K*dilated_rate neighbors. Falls back to
    random indices when there are too few reference points."""
    num_ref = ref_points.shape[0]
    if num_ref < K or num_ref < dilated_rate * K:
        rng = rng or np.random.default_rng()
        return rng.integers(0, num_ref, size=(query_points.shape[0], K)).astype(np.int32)
    if use_native():
        idx = native_lib.knn(ref_points, query_points, K * dilated_rate)
    else:
        tree = cKDTree(ref_points)
        _, idx = tree.query(query_points, k=K * dilated_rate)
        if K * dilated_rate == 1:
            idx = idx[:, None]
    if dilated_rate > 1:
        idx = idx[:, ::dilated_rate]
    return np.ascontiguousarray(idx, dtype=np.int32)


def subsample(coord: np.ndarray, norm: np.ndarray, grid_size=(0.1,)):
    """Grid-subsample each pyramid level without kNN."""
    point_list, norm_list = [], []
    for j, grid_s in enumerate(grid_size):
        if j == 0:
            point_list.append(coord.astype(np.float32))
            norm_list.append(norm.astype(np.float32))
        else:
            sub_point, sub_norm = grid_subsampling(
                point_list[-1], features=norm_list[-1], sampleDl=grid_s)
            if sub_point.shape[0] <= 16:  # too few points: keep previous level
                sub_point, sub_norm = point_list[-1], norm_list[-1]
            point_list.append(sub_point)
            norm_list.append(sub_norm)
    return point_list, norm_list


def subsample_and_knn(
    coord: np.ndarray,
    norm: np.ndarray,
    grid_size=(0.1,),
    K_self=16,
    K_forward=16,
    K_propagate=16,
    rng: np.random.Generator | None = None,
    morton: bool = False,
):
    """The full pyramid and the three kNN edge sets per level.

    Returns point_list, nei_forward_list, nei_propagate_list, nei_self_list,
    norm_list. morton=True sorts every level after the first into Z-order
    before its edges are built (level 0 is sorted by scene_to_item)."""
    if isinstance(K_self, int):
        K_self = [K_self] * len(grid_size)
    if isinstance(K_forward, int):
        K_forward = [K_forward] * len(grid_size)
    if isinstance(K_propagate, int):
        K_propagate = [K_propagate] * len(grid_size)

    point_list, norm_list = [], []
    nei_forward_list, nei_propagate_list, nei_self_list = [], [], []

    for j, grid_s in enumerate(grid_size):
        if j == 0:
            sub_point = coord.astype(np.float32)
            sub_norm = norm.astype(np.float32)
            point_list.append(sub_point)
            norm_list.append(sub_norm)
            nei_self_list.append(compute_knn(sub_point, sub_point, K_self[j], rng=rng))
        else:
            sub_point, sub_norm = grid_subsampling(
                point_list[-1], features=norm_list[-1], sampleDl=grid_s)
            if sub_point.shape[0] <= K_self[j]:
                sub_point, sub_norm = point_list[-1], norm_list[-1]
            elif morton:
                perm = morton_argsort(sub_point)
                sub_point, sub_norm = sub_point[perm], sub_norm[perm]

            nei_forward_list.append(
                compute_knn(point_list[-1], sub_point, K_forward[j], rng=rng))
            nei_propagate_list.append(
                compute_knn(sub_point, point_list[-1], K_propagate[j], rng=rng))
            nei_self_list.append(compute_knn(sub_point, sub_point, K_self[j], rng=rng))

            point_list.append(sub_point)
            norm_list.append(sub_norm)

    return point_list, nei_forward_list, nei_propagate_list, nei_self_list, norm_list


def scene_to_item(coord, norm, feats, labels, grid_size, K_self=16,
                  K_forward=16, K_propagate=16, rng=None,
                  morton: bool = False) -> dict:
    """One dataloader item dict: per-level points, normals and edges."""
    if morton:
        perm = morton_argsort(coord)
        coord, norm, feats = coord[perm], norm[perm], feats[perm]
        if labels is not None:
            labels = np.asarray(labels)[perm]
    point_list, nf, npg, ns, norm_list = subsample_and_knn(
        coord, norm, grid_size, K_self, K_forward, K_propagate, rng=rng,
        morton=morton)
    item = {
        "point_list": point_list,
        "surface_normal_list": norm_list,
        "feature_list": feats.astype(np.float32),
        "nei_forward_list": nf,
        "nei_propagate_list": npg,
        "nei_self_list": ns,
    }
    if labels is not None:
        item["label_list"] = labels.astype(np.int32)
    return item
