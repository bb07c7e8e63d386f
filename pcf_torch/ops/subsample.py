"""Voxel-grid barycenter subsampling: `grid_subsampling` for the host input
pipeline (numpy; the same arrays, in the same order, as
pcf_tpu/ops/subsample.grid_subsampling), and `grid_subsample_fixed`, the
static-shape version for the device pyramid (pcf_tpu's of the same name),
on the tensors' own device."""

from __future__ import annotations

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


def grid_subsampling(
    points: np.ndarray,
    features: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    sampleDl: float = 0.1,
):
    """Barycenter grid subsampling: voxel index from the floored
    min-corner-shifted coordinates; per-voxel mean of points and features and
    majority label. Voxels come out in sorted voxel-key order."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    origin = np.floor(points.min(axis=0) / sampleDl) * sampleDl
    cell = np.floor((points - origin) / sampleDl).astype(np.int64)
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]

    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    n_vox = uniq.shape[0]

    sub_points = np.zeros((n_vox, points.shape[1]), dtype=np.float64)
    np.add.at(sub_points, inv, points.astype(np.float64))
    sub_points = (sub_points / counts[:, None]).astype(np.float32)

    out = [sub_points]
    if features is not None:
        feats = np.ascontiguousarray(features, dtype=np.float64)
        sub_feats = np.zeros((n_vox, feats.shape[1]), dtype=np.float64)
        np.add.at(sub_feats, inv, feats)
        out.append((sub_feats / counts[:, None]).astype(np.float32))
    if labels is not None:
        lab = np.asarray(labels).reshape(-1).astype(np.int64)
        lab_shift = lab - lab.min()
        n_lab = int(lab_shift.max()) + 1
        hist = np.zeros((n_vox, n_lab), dtype=np.int64)
        np.add.at(hist, (inv, lab_shift), 1)
        out.append((hist.argmax(axis=1) + lab.min()).astype(np.int32))

    if len(out) == 1:
        return out[0]
    return tuple(out)


def grid_subsample_fixed(points: torch.Tensor, mask: torch.Tensor, sample_dl: float,
                         capacity: int, features: torch.Tensor | None = None,
                         labels: torch.Tensor | None = None, num_classes: int | None = None,
                         bid: torch.Tensor | None = None, n_scenes: int = 1) -> dict:
    """Static-shape grid subsampling of a packed batch: points sorted by
    voxel key (stable, so the segment sums add in pcf_tpu's order), then
    per-voxel barycenters, feature means and majority labels scattered into
    `capacity` rows. With `bid` (scene id per point, -1 on padding) the key
    separates scenes, all voxelized from one batch-global origin. Nothing is
    read back to the host.

    Returns a dict: points [capacity, 3] (padding at 1e6), feats (or None),
    labels (int32 majority per voxel, -100 where none; or None), bid
    [capacity] int32 (-1 on padding; or None), mask [capacity] bool, and
    overflow, a 0-d bool tensor: True when the input had more voxels than
    `capacity` (the excess dropped) or the scene-composed int32 key could
    overflow. An overflowed result is not valid.
    """
    pts = points.float()
    big = 1e6
    m = mask.bool()
    safe = torch.where(m[:, None], pts, big)
    origin = torch.floor(safe.min(0).values / sample_dl) * sample_dl
    cell = torch.floor((pts - origin) / sample_dl).int()
    dims = torch.where(m[:, None], cell, 0).max(0).values + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    # the int32 key range, checked in float as pcf_tpu checks it
    key_overflow = dims.float().prod() * n_scenes > float(_INT32_MAX)
    if bid is not None:
        key = key * n_scenes + bid.int().clamp(0, n_scenes - 1)
    key = torch.where(m, key, _INT32_MAX)  # padding sorts last

    order = torch.argsort(key, stable=True)
    key_s, mask_s = key[order], m[order]
    is_head = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                         key_s[1:] != key_s[:-1]]) & mask_s
    n_voxels = is_head.sum()
    seg_id = torch.cumsum(is_head.long(), 0) - 1
    seg_id = torch.where(mask_s & (seg_id < capacity), seg_id, capacity)
    cnt = torch.zeros(capacity + 1, device=pts.device).index_add_(0, seg_id, mask_s.float())

    def seg_mean(vals):
        acc = vals.new_zeros((capacity + 1, vals.shape[1])).index_add_(0, seg_id, vals)
        return (acc / cnt[:, None].clamp(min=1.0))[:capacity]

    sub_mask = cnt[:capacity] > 0
    out = {"points": torch.where(sub_mask[:, None], seg_mean(pts[order]), big),
           "feats": None, "labels": None, "bid": None, "mask": sub_mask,
           "overflow": (n_voxels > capacity) | key_overflow}
    if features is not None:
        out["feats"] = seg_mean(features.float()[order])
    if labels is not None:
        if num_classes is None:
            raise ValueError("grid_subsample_fixed: labels need num_classes for the vote")
        lab_s = labels[order].int()
        valid = mask_s & (lab_s >= 0) & (lab_s < num_classes)
        onehot = torch.nn.functional.one_hot(lab_s.clamp(0, num_classes - 1).long(),
                                             num_classes).int() * valid[:, None]
        hist = torch.zeros((capacity + 1, num_classes), dtype=torch.int32,
                           device=pts.device).index_add_(0, seg_id, onehot)[:capacity]
        voted = hist.argmax(1).int()
        out["labels"] = torch.where(sub_mask & (hist.sum(1) > 0), voted, -100)
    if bid is not None:
        bid_s = torch.where(mask_s, bid[order].int(), 0)
        sub_bid = torch.zeros(capacity + 1, dtype=torch.int32, device=pts.device
                              ).scatter_reduce_(0, seg_id, bid_s, "amax")[:capacity]
        out["bid"] = torch.where(sub_mask, sub_bid, -1)
    return out
