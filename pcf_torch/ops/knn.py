"""Brute-force kNN as tiled distance rows plus top-k, on the batch's device:
the port of pcf_tpu/ops/knn.py.

It works on the packed multi-cloud layout through per-point batch ids, so
neighbours never cross cloud boundaries. Two stages per query tile, as in
pcf_tpu:
  * a coarse ranking: the score 2 q.r - |r|^2, monotone in -|q - r|^2, from
    one f32 [q_tile, 3] x [3, N] product (TF32 is off for the package,
    pcf_torch/__init__.py), with invalid refs (masked, or of another cloud)
    at -_BIG, selects k + 16 candidates;
  * an exact re-rank of those candidates in diff form, which the product
    alone would miss by its cancellation: self edges are exactly 0 and come
    first.
Queries with fewer than k valid refs repeat their nearest valid ref.

The tile loop reads nothing back to the host (no .item(), nonzero or boolean
indexing), so a caller may capture it in a CUDA graph (data/post_knn.py).
"""

from __future__ import annotations

import torch

_BIG = 1e10
# cap on the [q_tile, N] score row (f32 elements) per tile; q_tile halves
# while a tile's row would exceed it (tests monkeypatch it)
_ROW_BUDGET = 256 * 1024 * 1024


def _pad_rows(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad], 0)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, *,
        query_bid: torch.Tensor | None = None, ref_bid: torch.Tensor | None = None,
        ref_mask: torch.Tensor | None = None, q_tile: int = 512, method: str = "exact",
        return_dist: bool = False):
    """k-nearest neighbours of `query` [M, D] among `ref` [N, D] (squared L2).

    query_bid / ref_bid: optional [M] / [N] cloud ids of a packed batch; a
    neighbour is valid only where they match. ref_mask: optional [N] bool,
    False on padding rows. q_tile: query rows per tile, halved (not below
    256) while q_tile * N exceeds _ROW_BUDGET. method: "exact" or "approx";
    both compute the exact top-k, as lax.approx_max_k does off the TPU.

    Returns idx [M, k] int32, by ascending distance (self first for
    self-queries), and with return_dist the squared distances [M, k] f32.
    The rows of a query whose cloud has no valid ref (padding, bid -1) are
    arbitrary: callers mask them.
    """
    if method not in ("exact", "approx"):
        raise ValueError(f"knn: unknown method {method!r}")
    M, D = query.shape
    N = ref.shape[0]
    while q_tile > 256 and q_tile * N > _ROW_BUDGET:
        q_tile //= 2
    q_tile = min(q_tile, max(8, M))
    Mp = -(-M // q_tile) * q_tile

    qf = _pad_rows(query.float(), Mp)
    rf = ref.float()
    r_invalid = (~ref_mask.bool() if ref_mask is not None
                 else torch.zeros(N, dtype=torch.bool, device=rf.device))
    rbid = ref_bid.int() if ref_bid is not None else None
    qbid = (_pad_rows(query_bid.int(), Mp, value=-2) if query_bid is not None
            else torch.zeros(Mp, dtype=torch.int32, device=rf.device))

    kc = min(N, k + 16)  # margin over the product's mis-ranked near-ties
    rr = (rf * rf).sum(1)
    negs, idxs = [], []
    for t in range(0, Mp, q_tile):
        q, qb = qf[t:t + q_tile], qbid[t:t + q_tile]
        s = 2.0 * (q @ rf.T) - rr[None, :]
        invalid = r_invalid[None, :]
        if rbid is not None:
            invalid = invalid | (qb[:, None] != rbid[None, :])
        s = torch.where(invalid, -_BIG, s)
        cand = torch.topk(s, kc, dim=1).indices

        d = ((rf[cand] - q[:, None, :]) ** 2).sum(-1)
        cand_invalid = r_invalid[cand]
        if rbid is not None:
            cand_invalid = cand_invalid | (qb[:, None] != rbid[cand])
        neg = torch.where(cand_invalid, -_BIG, -d)
        best_neg, sel = torch.topk(neg, k, dim=1)
        best_idx = torch.gather(cand, 1, sel)
        have = best_neg > -_BIG
        best_idx = torch.where(have, best_idx, best_idx[:, :1])
        best_neg = torch.where(have, best_neg, best_neg[:, :1])
        negs.append(best_neg)
        idxs.append(best_idx)
    idx = torch.cat(idxs)[:M].int()
    if return_dist:
        return idx, -torch.cat(negs)[:M]
    return idx


def knn_packed(points: torch.Tensor, bids: torch.Tensor, mask: torch.Tensor, k: int,
               query_points: torch.Tensor | None = None,
               query_bids: torch.Tensor | None = None, **kwargs) -> torch.Tensor:
    """kNN over a packed multi-cloud batch; self edges of `points` when
    query_points is None."""
    if query_points is None:
        query_points, query_bids = points, bids
    return knn(query_points, points, k, query_bid=query_bids, ref_bid=bids,
               ref_mask=mask, **kwargs)
