"""kNN within scenes on the card: csrc/knn_scene.cu.

For every query row, its k nearest valid reference rows of the same scene,
in the contract of ops/knn.py::knn_plain (the plain version, which the port
takes for CPU tensors): idx [M, k] int32 by ascending squared distance, ties
broken by self first and then by the lower row, a query with fewer than k
valid refs repeating its nearest, one whose scene has none given row 0 (at
distance 1e10). The kernel replaces no TPU kernel (pcf_tpu's kNN is plain
JAX); the CUDA source says why it was added and what bounds it.

`group` sorts a row set by scene on the card (a stable counting sort into
bins 0..S-1, S the scene count; bin S holds the rows left out) into a
workspace the library sizes; `search` launches one search of a query
grouping against a reference grouping. `knn_scene` does both for one call;
data/post_knn.compute_knn_packed groups each level once as references and
once as queries and searches its edge sets with them. Outputs and
workspaces come from torch.empty and nothing is read back to the host, so a
caller may capture the calls in a CUDA graph (data/post_knn.make_prepare).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pcf_torch.ops.kernels import build

INSTANCES = (16, 32)      # the kernel's list lengths (K): k <= K columns are written


def instance_k(k: int) -> int:
    """The list length the kernel keeps for k neighbours: the smallest of
    INSTANCES at least k. Raises for k < 1 or k above the largest."""
    for K in INSTANCES:
        if 1 <= k <= K:
            return K
    raise ValueError(f"knn_scene: k={k} outside 1..{INSTANCES[-1]}")


def scene_count(n_scenes: int | None, has_bids: bool, n_refs: int) -> int:
    """S, the scene bins of a call: 1 without reference scene ids; else the
    caller's n_scenes; else the reference row count, a bound on the scene
    ids of a packed batch (every scene keeps a row at every level)."""
    if not has_bids:
        return 1
    if n_scenes is not None:
        if n_scenes < 1:
            raise ValueError(f"knn_scene: n_scenes={n_scenes} must be at least 1")
        return int(n_scenes)
    return max(int(n_refs), 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("knn_scene")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.knn_scene_group.argtypes = [p, p, p, i, i, p, ll, p]
    lib.knn_scene_group.restype = i
    lib.knn_scene_search.argtypes = [i, p, i, p, i, i, i, i, p, p, p]
    lib.knn_scene_search.restype = i
    lib.knn_scene_group_bytes.argtypes = [i, i]
    lib.knn_scene_group_bytes.restype = ll
    return lib


class Grouping(NamedTuple):
    """A row set grouped by scene: the library's workspace, the rows, S."""
    ws: torch.Tensor
    rows: int
    scenes: int


def _check_rows(points, bid, mask):
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"knn_scene: points must be a CUDA tensor, got {device}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"knn_scene: points must be [n, 3], got {tuple(points.shape)}")
    n = points.shape[0]
    if bid is not None and (bid.device != device or bid.shape != (n,)):
        raise ValueError(f"knn_scene: scene ids must be [{n}] on {device}")
    if mask is not None and (mask.device != device or mask.shape != (n,)):
        raise ValueError(f"knn_scene: the mask must be [{n}] on {device}")
    if not 1 <= n < 1 << 31:
        raise ValueError(f"knn_scene: {n} rows, outside 1..2**31-1")


def group(points: torch.Tensor, bid: torch.Tensor | None, mask: torch.Tensor | None,
          n_scenes: int) -> Grouping:
    """points [n, 3] (as float32) grouped by scene on their card: bid [n]
    scene ids (None: every row in scene 0; an id outside [0, n_scenes) has
    no scene), mask [n] (None: every row valid; False: left out). One call
    of the library: a memset and four kernels."""
    _check_rows(points, bid, mask)
    points = points.float().contiguous()
    bid = None if bid is None else bid.int().contiguous()
    mask = None if mask is None else mask.bool().contiguous()
    n, lib = points.shape[0], _lib()
    nbytes = lib.knn_scene_group_bytes(n, n_scenes)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=points.device)
    err = lib.knn_scene_group(
        points.data_ptr(), 0 if bid is None else bid.data_ptr(),
        0 if mask is None else mask.data_ptr(), n, n_scenes, ws.data_ptr(), nbytes,
        torch.cuda.current_stream(points.device).cuda_stream)
    if err:
        raise RuntimeError(f"knn_scene grouping failed with CUDA error {err}")
    return Grouping(ws, n, n_scenes)


def search(queries: Grouping, refs: Grouping, k: int, *, self_search: bool = False,
           return_dist: bool = False):
    """k nearest of each query row among the valid reference rows of its
    scene: queries grouped without a mask, refs with theirs, with one S.
    self_search: the queries are the references' own rows, and a row ranks
    first among its ties. Returns idx [M, k] int32 and, with return_dist,
    the squared distances [M, k] f32 the kernel ranked on."""
    if queries.scenes != refs.scenes or queries.ws.device != refs.ws.device:
        raise ValueError("knn_scene: query and reference groupings of other scenes or cards")
    K = instance_k(k)
    device, M = queries.ws.device, queries.rows
    idx = torch.empty((M, k), dtype=torch.int32, device=device)
    dist = torch.empty((M, k), dtype=torch.float32, device=device) if return_dist else None
    err = _lib().knn_scene_search(
        K, queries.ws.data_ptr(), M, refs.ws.data_ptr(), refs.rows, refs.scenes, k,
        int(self_search), idx.data_ptr(), 0 if dist is None else dist.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"knn_scene launch failed with CUDA error {err}")
    knn_scene.launches += 1
    return (idx, dist) if return_dist else idx


def knn_scene(query: torch.Tensor, ref: torch.Tensor, k: int, *,
              query_bid: torch.Tensor | None = None, ref_bid: torch.Tensor | None = None,
              ref_mask: torch.Tensor | None = None, n_scenes: int | None = None,
              return_dist: bool = False):
    """k nearest valid rows of `ref` [N, 3] for each row of `query` [M, 3]
    (on one card), within scenes: query_bid / ref_bid scene ids (a row whose
    id is outside [0, S) has no scene; without ref_bid every row is in one
    scene and query_bid is not read), ref_mask (False: never a neighbour).
    S: scene_count(n_scenes, ...). Returns as `search`; the self search
    (query is ref) puts each row first among its ties."""
    instance_k(k)
    if query.device != ref.device:
        raise ValueError(f"knn_scene: query on {query.device}, ref on {ref.device}")
    M = query.shape[0]
    if M == 0:
        idx = torch.empty((0, k), dtype=torch.int32, device=ref.device)
        return (idx, torch.empty((0, k), device=ref.device)) if return_dist else idx
    S = scene_count(n_scenes, ref_bid is not None, ref.shape[0])
    self_search = query.data_ptr() == ref.data_ptr() and query.shape == ref.shape
    return search(group(query, query_bid if ref_bid is not None else None, None, S),
                  group(ref, ref_bid, ref_mask, S), k, self_search=self_search,
                  return_dist=return_dist)


knn_scene.launches = 0
