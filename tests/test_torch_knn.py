"""pcf_torch.ops.knn against pcf_tpu.ops.knn on the same seeded inputs: the
six cases of tests/test_knn.py (brute force, self first, batch ids, mask,
fewer refs than k, sorted distances), each against pcf_tpu's knn called
with method="exact", plus return_dist, the q_tile shrink under a small
_ROW_BUDGET on both sides, and the "approx" wiring. Distances agree to 1e-6
relative; indices agree wherever the distances are distinct (ties may be
broken otherwise)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcf_tpu.ops.knn import knn as j_knn
from pcf_tpu.ops.knn import knn_packed as j_knn_packed

from pcf_torch.ops.knn import knn as t_knn
from pcf_torch.ops.knn import knn_packed as t_knn_packed

# pcf_tpu.ops exports the function under the module's name
j_knn_mod = importlib.import_module("pcf_tpu.ops.knn")
t_knn_mod = importlib.import_module("pcf_torch.ops.knn")

DIST_RTOL = 1e-6
# tie detection: neighbouring distances closer than this (relative) count as tied
TIE_RTOL = 1e-6


def _np_knn_dists(query, ref, k, q_bid=None, r_bid=None, r_mask=None):
    d = ((query[:, None, :].astype(np.float64) - ref[None, :, :]) ** 2).sum(-1)
    if r_mask is not None:
        d[:, ~r_mask] = np.inf
    if q_bid is not None:
        d[q_bid[:, None] != r_bid[None, :]] = np.inf
    return np.sort(d, axis=1)[:, :k]


def _both(q, r, k, **kw):
    """(pcf_tpu's (idx, dist), the port's (idx, dist)) as numpy."""
    jkw = {n: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for n, v in kw.items()}
    tkw = {n: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for n, v in kw.items()}
    ji, jd = j_knn(jnp.asarray(q), jnp.asarray(r), k, method="exact", return_dist=True, **jkw)
    ti, td = t_knn(torch.from_numpy(q), torch.from_numpy(r), k, return_dist=True, **tkw)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    return (np.asarray(ji), np.asarray(jd)), (ti.numpy(), td.numpy())


def _check_same(j, t, valid_rows=None):
    """Distances within DIST_RTOL; each row's index set equal where its
    distances are distinct from their neighbours'."""
    (ji, jd), (ti, td) = j, t
    rows = slice(None) if valid_rows is None else valid_rows
    np.testing.assert_allclose(td[rows], jd[rows], rtol=DIST_RTOL, atol=1e-12)
    for i in np.arange(jd.shape[0])[rows]:
        d = jd[i]
        gaps = np.diff(d) > TIE_RTOL * np.maximum(d[1:], 1e-12)
        distinct = np.ones(d.shape[0], bool)
        distinct[1:] &= gaps
        distinct[:-1] &= gaps
        np.testing.assert_array_equal(ti[i][distinct], ji[i][distinct], err_msg=f"row {i}")


def test_knn_matches_bruteforce_and_pcf_tpu(rng):
    q = rng.normal(size=(101, 3)).astype(np.float32)
    r = rng.normal(size=(257, 3)).astype(np.float32)
    j, t = _both(q, r, 8, q_tile=32)
    _check_same(j, t)
    want = _np_knn_dists(q, r, 8)
    np.testing.assert_allclose(t[1], want, rtol=1e-5, atol=1e-6)
    d_from_idx = ((q[:, None, :].astype(np.float64) - r[t[0]]) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(d_from_idx, 1), want, rtol=1e-5, atol=1e-6)


def test_knn_self_first():
    pts = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    j, t = _both(pts, pts, 4, q_tile=16)
    np.testing.assert_array_equal(t[0][:, 0], np.arange(50))
    assert (t[1][:, 0] == 0).all()
    _check_same(j, t)


def test_knn_respects_batch_ids(rng):
    pts = rng.normal(size=(60, 3)).astype(np.float32)
    bids = np.repeat(np.arange(3), 20).astype(np.int32)
    mask = np.ones(60, bool)
    ji = np.asarray(j_knn_packed(jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(mask), 5,
                                 q_tile=16, method="exact"))
    ti = t_knn_packed(torch.from_numpy(pts), torch.from_numpy(bids), torch.from_numpy(mask),
                      5, q_tile=16).numpy()
    for i in range(60):
        assert np.all(bids[ti[i]] == bids[i]), i
    j, t = _both(pts, pts, 5, q_tile=16, query_bid=bids, ref_bid=bids, ref_mask=mask)
    np.testing.assert_array_equal(t[0], ti)
    np.testing.assert_array_equal(j[0], ji)
    _check_same(j, t)
    want = _np_knn_dists(pts, pts, 5, bids, bids)
    np.testing.assert_allclose(t[1], want, rtol=1e-5, atol=1e-6)


def test_knn_respects_mask(rng):
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    mask = np.ones(40, bool)
    mask[25:] = False
    j, t = _both(pts[:10], pts, 6, ref_mask=mask, q_tile=8)
    assert t[0].max() < 25
    _check_same(j, t)


def test_knn_fewer_refs_than_k(rng):
    """With fewer than k valid refs a row repeats its nearest valid ref."""
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    mask = np.zeros(16, bool)
    mask[:3] = True
    j, t = _both(pts[:4], pts, 8, ref_mask=mask, q_tile=8)
    assert t[0].max() < 3
    np.testing.assert_array_equal(t[0][:, 3:], np.repeat(t[0][:, :1], 5, 1))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=DIST_RTOL)


def test_knn_dists_sorted(rng):
    q = rng.normal(size=(33, 3)).astype(np.float32)
    r = rng.normal(size=(77, 3)).astype(np.float32)
    j, t = _both(q, r, 9, q_tile=16)
    assert np.all(np.diff(t[1], axis=1) >= 0)
    _check_same(j, t)


def test_knn_return_dist_is_the_index_distance(rng):
    """return_dist gives exactly the diff-form distance of each index, and
    without it the same indices come back alone."""
    q = rng.normal(size=(70, 3)).astype(np.float32)
    r = rng.normal(size=(90, 3)).astype(np.float32)
    idx, dist = t_knn(torch.from_numpy(q), torch.from_numpy(r), 7, q_tile=32,
                      return_dist=True)
    np.testing.assert_array_equal(
        t_knn(torch.from_numpy(q), torch.from_numpy(r), 7, q_tile=32).numpy(), idx.numpy())
    diff = r[idx.numpy()] - q[:, None, :]
    want = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
    np.testing.assert_array_equal(dist.numpy(), want)


def test_knn_q_tile_shrinks_under_the_row_budget(rng, monkeypatch):
    """A small _ROW_BUDGET halves q_tile (not below 256) on both sides; the
    result is the same as with one tile."""
    q = rng.normal(size=(700, 3)).astype(np.float32)
    r = rng.normal(size=(600, 3)).astype(np.float32)
    seen = []
    real_topk = torch.topk

    def counting_topk(x, k, **kw):
        seen.append(x.shape[0])
        return real_topk(x, k, **kw)

    one = t_knn(torch.from_numpy(q), torch.from_numpy(r), 6, q_tile=1024, return_dist=True)
    # pcf_tpu reads the budget while tracing: these shapes are traced here first
    monkeypatch.setattr(j_knn_mod, "_ROW_BUDGET", 256 * 600)
    monkeypatch.setattr(t_knn_mod, "_ROW_BUDGET", 256 * 600)
    monkeypatch.setattr(torch, "topk", counting_topk)
    j, t = _both(q, r, 6, q_tile=1024)
    # 1024 -> 512 -> 256; 700 rows padded to 768: three tiles, two top-k each
    assert seen == [256] * 6
    _check_same(j, t)
    np.testing.assert_array_equal(one[0].numpy(), t[0])
    np.testing.assert_array_equal(one[1].numpy(), t[1])


def test_knn_approx_is_exact():
    """method="approx" computes the exact top-k (lax.approx_max_k off the
    TPU does too): the same edges as "exact", and as pcf_tpu's "approx"
    edge sets."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 4, size=(300, 3)).astype(np.float32)
    bids = np.repeat(np.arange(2), 150).astype(np.int32)
    mask = np.ones(300, bool)
    args = (torch.from_numpy(pts), torch.from_numpy(bids), torch.from_numpy(mask), 8)
    approx = t_knn_packed(*args, method="approx").numpy()
    np.testing.assert_array_equal(approx, t_knn_packed(*args, method="exact").numpy())
    ja = np.asarray(j_knn_packed(jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(mask), 8,
                                 method="approx"))
    assert [set(a) for a in approx] == [set(a) for a in ja]
    with pytest.raises(ValueError, match="method"):
        t_knn_packed(*args, method="kd")
