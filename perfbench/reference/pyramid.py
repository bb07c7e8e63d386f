"""The reference's multi-resolution pyramid: voxel-barycenter grid
subsampling per level (numpy) and brute-force kNN per scene (torch), the
three edge sets of every level, and the scenes of a batch concatenated.

The subsampling is a frozen copy of the program's numpy version at the time
the benchmark was written: voxel index from the floored, min-corner-shifted
coordinates, per-voxel mean of points and normals summed in float64,
voxels in sorted key order. A level with no more points than K keeps the
previous level. The kNN compares every query with every reference row of
its own scene, in blocks of queries, by squared distance in float32; the
point itself is its own nearest neighbour.

It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_subsample(points: np.ndarray, normals: np.ndarray, dl: float):
    points = np.ascontiguousarray(points, dtype=np.float32)
    origin = np.floor(points.min(axis=0) / dl) * dl
    cell = np.floor((points - origin) / dl).astype(np.int64)
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    out = []
    for x in (points, normals):
        acc = np.zeros((counts.shape[0], 3), np.float64)
        np.add.at(acc, inv.reshape(-1), x.astype(np.float64))
        out.append((acc / counts[:, None]).astype(np.float32))
    return out[0], out[1]


def level_points(coord: np.ndarray, normals: np.ndarray, grid, k_self):
    """([points per level], [normals per level]) of one scene: level 0 the
    scene itself, then each grid size's barycenters (normals averaged, not
    renormalised, as the program's host pyramid)."""
    pts, nrm = [coord.astype(np.float32)], [normals.astype(np.float32)]
    for lvl in range(1, len(grid)):
        p, n = grid_subsample(pts[-1], nrm[-1], grid[lvl])
        if p.shape[0] <= k_self[lvl]:
            p, n = pts[-1], nrm[-1]
        pts.append(p)
        nrm.append(n)
    return pts, nrm


def knn(refs: torch.Tensor, queries: torch.Tensor, k: int, block: int = 4096):
    """[Q, k] int64: the k rows of `refs` nearest to each query, nearest
    first, by squared distance (dx^2 + dy^2 + dz^2 in float32)."""
    out = []
    for s in range(0, queries.shape[0], block):
        d = (queries[s:s + block, None, :] - refs[None, :, :]).pow(2).sum(-1)
        out.append(torch.topk(d, k, dim=1, largest=False, sorted=True).indices)
    return torch.cat(out)


def knn_distances(refs: torch.Tensor, queries: torch.Tensor, nei: torch.Tensor):
    """Squared distances [Q, K] from each query to the rows `nei` names."""
    return (refs[nei] - queries[:, None, :]).pow(2).sum(-1)


def scene_set(scenes, grid, ks, device, with_edges: bool = True) -> dict:
    """The batch as one set of rows: `scenes` is a list of (coord, colour,
    normals, label) level-0 arrays; ks = (K_self, K_forward, K_propagate) per
    level. Returns points, norms (lists per level), feats, labels, bids
    (scene ids per level) and, with edges, edges_self / forward / propagate
    as row indices into the concatenated levels."""
    L = len(grid)
    k_self, k_fwd, k_prop = ks
    per = [level_points(c, n, grid, k_self) for c, _, n, _ in scenes]
    s = {"points": [], "norms": [], "bids": [], "offsets": []}
    for lvl in range(L):
        sizes = [p[0][lvl].shape[0] for p in per]
        s["offsets"].append(np.cumsum([0] + sizes))
        s["points"].append(torch.from_numpy(np.concatenate([p[0][lvl] for p in per])).to(device))
        s["norms"].append(torch.from_numpy(np.concatenate([p[1][lvl] for p in per])).to(device))
        s["bids"].append(torch.from_numpy(np.concatenate(
            [np.full(n, i, np.int64) for i, n in enumerate(sizes)])).to(device))
    s["feats"] = torch.from_numpy(np.concatenate([c for _, c, _, _ in scenes])).to(device)
    s["labels"] = torch.from_numpy(np.concatenate([lab for *_, lab in scenes]).astype(
        np.int64)).to(device)
    if not with_edges:
        return s

    def edges(q_lvl, r_lvl, k):
        rows = []
        for i in range(len(scenes)):
            qo, ro = s["offsets"][q_lvl], s["offsets"][r_lvl]
            q = s["points"][q_lvl][qo[i]:qo[i + 1]]
            r = s["points"][r_lvl][ro[i]:ro[i + 1]]
            rows.append(knn(r, q, k) + int(ro[i]))
        return torch.cat(rows)

    s["edges_self"] = [edges(lvl, lvl, k_self[lvl]) for lvl in range(L)]
    s["edges_forward"] = [edges(lvl + 1, lvl, k_fwd[lvl + 1]) for lvl in range(L - 1)]
    s["edges_propagate"] = [edges(lvl, lvl + 1, k_prop[lvl]) for lvl in range(L - 1)]
    return s
