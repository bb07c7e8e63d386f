"""Host-side logic of the port's kernels that runs without a card: kernel E's
packed weights (their layout and the cache that keeps them between calls),
kernel A's launch plan (route, lanes per edge, grid and shared memory), the
workspaces that the wrappers of kernels B, C and D size on the host for
the kernels' fixed-order sums, and the kNN kernel's plan (the list length
it instantiates and its scene count) with the dispatch of CPU tensors to
the plain kNN by ops/knn.knn and data/post_knn.compute_knn_packed.

The kernels themselves are held against their plain versions on the card
(tests/test_torch_kernels_gpu.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pcf_torch.ops.kernels.layer_eval import packed_weights
from pcf_torch.ops.kernels.pconv_fused import workspace_bytes
from pcf_torch.ops.kernels.window_resolve import launch_plan, plan_for
from pcf_torch.ops.kernels.window_scatter import piece_len, workspace_layout
from pcf_torch.ops.kernels import knn_scene as knn_mod


def _pairs(rng, dims):
    return [(torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
            for ci, co in zip(dims, dims[1:])]


def _layer(seed=0):
    """Folded weights of a small guided layer: WeightNet 12-8-8-3, PE 12-5,
    guidance (4+5)-6-2, linear [Cx*W, O] = [8*3, 13]."""
    rng = np.random.default_rng(seed)
    wn, pe, gd = _pairs(rng, [12, 8, 8, 3]), _pairs(rng, [12, 5]), _pairs(rng, [9, 6, 2])
    lw = torch.from_numpy(rng.standard_normal((24, 13)).astype(np.float32))
    lb = torch.from_numpy(rng.standard_normal(13).astype(np.float32))
    return wn, pe, gd, lw, lb


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packed_weights_layout(bf16):
    """Each MLP layer at its descriptor's offsets: w [din, dp] then b [dp],
    zero-padded to dp columns (a power of two, at least 4), offsets
    multiples of 4 floats, weights and biases f32 for either table (the
    MLPs run in f32); L the f32 weight, or its bf16 copy padded to 8
    columns."""
    wn, pe, gd, lw, lb = _layer()
    pk = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert pk.params.dtype == torch.float32 and pk.params.numel() % 4 == 0
    for pairs, d in zip((wn, pe, gd), pk.mlps):
        assert d.n == len(pairs)
        for i, (w, b) in enumerate(pairs):
            din, dout = w.shape
            dp = {2: 4, 3: 4, 5: 8, 6: 8, 8: 8}[dout]
            assert (d.din[i], d.dout[i]) == (din, dout) and d.w[i] % 4 == 0 == d.b[i] % 4
            got_w = pk.params[d.w[i]:d.w[i] + din * dp].reshape(din, dp)
            assert torch.equal(got_w[:, :dout], w)
            assert not got_w[:, dout:].any()
            got_b = pk.params[d.b[i]:d.b[i] + dp]
            assert torch.equal(got_b[:dout], b) and not got_b[dout:].any()
    if bf16:
        assert pk.L.dtype == torch.bfloat16 and pk.L.shape == (24, 16)
        assert torch.equal(pk.L[:, :13], lw.bfloat16()) and not pk.L[:, 13:].any()
    else:
        assert torch.equal(pk.L, lw)
    assert torch.equal(pk.bias, lb)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packed_weights_cache_follows_updates(bf16):
    """A second call with the same tensors packs nothing; an in-place update
    of any folded tensor (its _version) packs again, with the new values;
    the f32 and bf16 forms are kept apart."""
    wn, pe, gd, lw, lb = _layer(1)
    first = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert packed_weights(wn, pe, gd, lw, lb, bf16) is first
    other = packed_weights(wn, pe, gd, lw, lb, not bf16)
    assert other is not first and packed_weights(wn, pe, gd, lw, lb, bf16) is first

    lw.mul_(2.0)
    second = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert second is not first
    want = lw.bfloat16() if bf16 else lw
    assert torch.equal(second.L[:, :13], want)

    gd[0][0].add_(1.0)
    third = packed_weights(wn, pe, gd, lw, lb, bf16)
    assert third is not second
    d = third.mlps[2]
    got = third.params[d.w[0]:d.w[0] + 9 * 8].reshape(9, 8)[:, :6]
    assert torch.equal(got, gd[0][0])
    assert packed_weights(wn, pe, gd, lw, lb, bf16) is third


# the tables the flagship forward resolves: geometry xyz (C=3) and
# xyz+norms (C=6), f32 under either compute dtype; the PCF layers' features
# (C=32); the transposes' features, with the geometry concatenated in f32
# (96+6 ... 288+6) and alone in bf16 (96 ... 288)
FLAGSHIP_ROWS = {  # (C, element bytes): (route, unit, lanes)
    (3, 4): ("narrow", 4, 0), (6, 4): ("narrow", 8, 0), (32, 4): ("wide", 16, 8),
    (102, 4): ("narrow", 8, 0), (166, 4): ("narrow", 8, 0), (230, 4): ("narrow", 8, 0),
    (294, 4): ("narrow", 8, 0),
    (3, 2): ("narrow", 2, 0), (6, 2): ("narrow", 4, 0), (32, 2): ("wide", 16, 4),
    (96, 2): ("wide", 16, 12), (160, 2): ("wide", 16, 20), (224, 2): ("wide", 16, 28),
    (288, 2): ("wide", 16, 18),
}


@pytest.mark.parametrize("C,esize", list(FLAGSHIP_ROWS),
                         ids=[f"{'f32' if e == 4 else 'bf16'}-C{c}" for c, e in FLAGSHIP_ROWS])
def test_resolve_route_of_every_flagship_row(C, esize):
    """Rows of 16-byte multiples take the wide route, one lane per 16 bytes
    up to 32 (288 bf16 channels, 36 vectors: two passes of 18 lanes); the
    rest the narrow one in units of their alignment."""
    route, unit, lanes = FLAGSHIP_ROWS[(C, esize)]
    plan = launch_plan(320, 2048, C * esize, 16)
    assert (plan["route"], plan["unit"], plan["lanes"]) == (route, unit, lanes)
    if route == "wide":  # every pass but the last takes all lanes
        chunks = C * esize // 16
        passes = -(-chunks // lanes)
        assert (passes - 1) * lanes < chunks <= passes * lanes and lanes <= 32
        assert chunks > (passes - 1) * 32


@pytest.mark.parametrize("C,dtype,offset,unit", [
    (6, torch.float32, 6, 8),     # f32 xyz+norms, one row in: 24 bytes
    (3, torch.bfloat16, 3, 2),    # bf16 xyz, one row in: 6 bytes
    (32, torch.float32, 1, 4),    # a wide row one element in: 4 bytes
    (32, torch.bfloat16, 1, 2),
    (32, torch.bfloat16, 32, 16),  # a whole 64-byte row in: still aligned, still wide
    (4, torch.float32, 4, 16),    # 16-byte rows: wide, one lane an edge
])
def test_resolve_route_of_a_misaligned_table_view(C, dtype, offset, unit):
    """A table view starting `offset` elements into its storage reads in
    units of the alignment it has left; only a 16-byte-aligned table of
    16-byte-multiple rows takes the wide route."""
    storage = torch.zeros(64 * C + offset, dtype=dtype)
    assert storage.data_ptr() % 16 == 0
    table = storage[offset:].view(64, C)
    edges = torch.zeros(320, 2048, dtype=torch.int32), torch.zeros(320, 1, 2048, dtype=torch.int32)
    plan = plan_for(table, *edges)
    assert plan["unit"] == unit and plan["grid"] == (320, 1)
    assert (plan["route"], plan["lanes"]) == (
        ("wide", C * table.element_size() // 16) if unit == 16 else ("narrow", 0))


def test_resolve_grid_at_the_coarsest_and_finest_levels():
    """T = 4 tiles (M = 512, K = 16, 128-point tiles) split in grid.y until
    the grid reaches two blocks an SM, no block under 64 edges: 32 blocks of
    64 edges a tile. T = 320 (M = 40960): one block a tile, 2048 edges."""
    for row_bytes in (24, 128, 64, 1176):
        small, large = launch_plan(4, 2048, row_bytes, 16), launch_plan(320, 2048, row_bytes, 16)
        assert small["grid"] == (4, 32) and small["edges_per_block"] == 64
        assert large["grid"] == (320, 1) and large["edges_per_block"] == 2048
        assert small["lanes"] == large["lanes"] == (
            {24: 0, 128: 8, 64: 4, 1176: 0}[row_bytes])
    mid = launch_plan(128, 2048, 128, 16)  # M = 16384: 3 blocks a tile
    assert mid["grid"] == (128, 3) and mid["edges_per_block"] == 688


@pytest.mark.parametrize("T,MtK", [(1, 2048), (4, 2048), (320, 2048), (2, 65536), (7, 80)])
def test_resolve_plan_covers_each_tile_within_the_shared_memory_limit(T, MtK):
    """Every tile's edges are covered by its grid.y blocks, each block's
    first edge is a multiple of 16 (its output starts 16-byte aligned), and
    the rows it stages stay far under the 48 KiB a block may have without
    opting in: 8 KiB at Mt*K = 2048, 16 KiB at most."""
    plan = launch_plan(T, MtK, 24, 16)
    epb, (gx, gy) = plan["edges_per_block"], plan["grid"]
    assert gx == T and (gy - 1) * epb < MtK <= gy * epb
    assert epb % 16 == 0 and plan["threads"] == 256
    assert plan["smem"] == 4 * epb <= 16 * 1024 < 48 * 1024
    if MtK == 2048:
        assert plan["smem"] <= 8 * 1024


@pytest.mark.parametrize("c_splits,M,O,want", [
    (1, 40960, 160, 0),                       # one range: no workspace
    (5, 512, 160, 4 * 5 * 512 * 160),         # B, PCFLayer C=80 at M=512, bf16
    (2, 4096, 64, 4 * 2 * 4096 * 64),
])
def test_conv_linear_workspace_from_the_launch_shape(c_splits, M, O, want):
    """Kernels B and C with split channel ranges: an f32 [M, O] slot per
    range, which a second launch adds in range order; none without a
    split."""
    assert workspace_bytes(c_splits, M, O) == want


def test_window_scatter_workspace_layout():
    """Kernel D's workspaces at the padding-fan-in test's sizes (6,000 rows,
    8192 x 16 edges, C = 64): pieces of 128 positions (4x the mean fan-in 21,
    as a power of two), 64 sort tiles of 2048 edges, 2 radix passes of 8
    bits (keys 0..6000), 1024 pieces. The inverse: keys, ids (twice each),
    histograms, digit totals and row offsets; the reduction: the pieces'
    head and tail slots; each section 16-byte aligned."""
    lay = workspace_layout(6000, 8192 * 16, 64)
    E = 8192 * 16
    assert (lay["cap"], lay["tiles"], lay["passes"], lay["pieces"]) == (128, 64, 2, 1024)
    assert [lay[k] for k in ("key0", "val0", "key1", "val1", "hist", "total", "offsets",
                             "inverse_bytes")] == [
        0, 4 * E, 8 * E, 12 * E, 16 * E, 16 * E + 4 * 256 * 64, 16 * E + 4 * 256 * 65,
        16 * E + 4 * 256 * 65 + 24016]
    assert [lay[k] for k in ("head", "tail", "reduce_bytes")] == [
        0, 4 * 1024 * 64, 8 * 1024 * 64]


@pytest.mark.parametrize("n_rows,edges,C", [(1, 0, 8), (70000, 5, 3), (40960, 40960 * 16, 32),
                                            (188416, 3014656, 64), (65535, 1000, 16),
                                            (65536, 1000, 16)])
def test_window_scatter_workspace_covers_its_sections(n_rows, edges, C):
    """Every section in order, 16-byte aligned, and as long as its contents;
    the radix passes cover every key, 0..n_rows (n_rows: a dropped edge);
    the piece length 32 to 256, a power of two, at least the mean fan-in."""
    lay = workspace_layout(n_rows, edges, C)
    for names, sizes in ((("key0", "val0", "key1", "val1", "hist", "total", "offsets",
                           "inverse_bytes"),
                          (4 * edges,) * 4 + (4 * 256 * lay["tiles"], 4 * 256,
                                              4 * (n_rows + 1))),
                         (("head", "tail", "reduce_bytes"), (4 * lay["pieces"] * C,) * 2)):
        assert lay[names[0]] == 0
        for a, b, size in zip(names, names[1:], sizes):
            assert lay[a] % 16 == 0 and lay[b] >= lay[a] + size, (a, b)
        assert lay[names[-1]] % 16 == 0
    assert 2 ** (8 * lay["passes"]) > n_rows >= 2 ** (8 * (lay["passes"] - 1)) - 1
    cap = piece_len(n_rows, edges)
    assert cap == lay["cap"] and cap in (32, 64, 128, 256)
    assert cap >= min(4 * (edges // n_rows), 256) or cap == 32
    assert lay["tiles"] == -(-edges // 2048) and lay["pieces"] == -(-edges // cap)


@pytest.mark.parametrize("k,K", [(1, 16), (5, 16), (16, 16), (17, 32), (32, 32)])
def test_knn_scene_instance_of_k(k, K):
    """The kNN kernel keeps the smallest list of INSTANCES at least k."""
    assert knn_mod.instance_k(k) == K


@pytest.mark.parametrize("k", [0, 33, 64])
def test_knn_scene_refuses_k_beyond_its_instances(k):
    with pytest.raises(ValueError, match=f"k={k}"):
        knn_mod.instance_k(k)


def test_knn_scene_scene_count():
    """S: 1 without reference scene ids, the caller's n_scenes, else the
    reference row count; n_scenes below 1 refused."""
    assert knn_mod.scene_count(16, False, 500) == 1
    assert knn_mod.scene_count(16, True, 500) == 16
    assert knn_mod.scene_count(None, True, 2048) == 2048
    with pytest.raises(ValueError, match="n_scenes"):
        knn_mod.scene_count(0, True, 10)


def test_prepare_passes_the_scene_count(monkeypatch):
    """Under post_knn the preparation's key carries cfg.BATCH_SIZE, and
    compute_knn_packed gets it as n_scenes (None without BATCH_SIZE)."""
    from pcf_torch.config import Config
    from pcf_torch.data import post_knn

    seen = []
    monkeypatch.setattr(post_knn, "compute_knn_packed",
                        lambda batch, *a, **kw: seen.append((a, kw)) or batch)
    cfg = Config(grid_size=[0.1, 0.2], K_self=16, K_forward=16, K_propagate=16, BATCH_SIZE=4,
                 post_knn=True)
    assert post_knn.static_args(cfg, 1024) == ("post_knn", 4, (16, 16), (16, 16), (16, 16),
                                               "approx")
    batch = SimpleNamespace(points=[torch.zeros(1024, 3)])
    post_knn.prepare_flagged(batch, cfg)
    del cfg["BATCH_SIZE"]
    post_knn.prepare_flagged(batch, cfg)
    assert seen == [(((16, 16), (16, 16), (16, 16), "approx"), {"n_scenes": 4}),
                    (((16, 16), (16, 16), (16, 16), "approx"), {"n_scenes": None})]


def _refuse_the_kernel(monkeypatch):
    """The kernel's wrapper, where ops/knn and data/post_knn reach it, raises."""
    from pcf_torch.ops import knn as knn_ops

    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(knn_ops, "knn_scene", refuse)
    monkeypatch.setattr(knn_mod, "group", refuse)
    monkeypatch.setattr(knn_mod, "search", refuse)


def _pyramid_without_edges():
    """A packed batch of two scenes' host pyramids (2 levels), no edges."""
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.pyramid import subsample
    from pcf_torch.data.synthetic import synthetic_scene

    items = []
    for seed in (1, 2):
        coord, norm, feats, labels = synthetic_scene(400, extent=3.0, seed=seed)
        pts, nrm = subsample(coord.astype(np.float32), norm.astype(np.float32),
                             grid_size=[0.1, 0.3])
        items.append({"point_list": pts, "surface_normal_list": nrm,
                      "feature_list": feats.astype(np.float32),
                      "label_list": labels.astype(np.int32)})
    return pack_scenes(items, bucket_multiple=64)


def test_knn_of_cpu_tensors_runs_the_plain_version(monkeypatch):
    """ops/knn.knn on CPU tensors is knn_plain, bit for bit, and never
    reaches the kernel's wrapper."""
    from pcf_torch.ops import knn as knn_ops

    _refuse_the_kernel(monkeypatch)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(90, 3)).astype(np.float32))
    bid = torch.from_numpy(np.repeat(np.arange(3), 30).astype(np.int32))
    mask = torch.ones(90, dtype=torch.bool)
    kw = dict(query_bid=bid, ref_bid=bid, ref_mask=mask, return_dist=True)
    got = knn_ops.knn(pts, pts, 6, n_scenes=3, q_tile=32, **kw)
    want = knn_ops.knn_plain(pts, pts, 6, q_tile=32, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_compute_knn_packed_of_cpu_tensors_runs_the_plain_version(monkeypatch, method):
    """compute_knn_packed on CPU tensors makes each edge set with
    ops/knn.knn_plain, bit for bit, and never reaches the kernel's wrapper;
    either method is the exact kNN."""
    from pcf_torch.data import post_knn
    from pcf_torch.ops.knn import knn_plain

    _refuse_the_kernel(monkeypatch)
    b = _pyramid_without_edges()
    got = post_knn.compute_knn_packed(b, (8, 6), (8, 5), (4, 8), method=method, n_scenes=2)

    def plain(q, r, k):
        return knn_plain(b.points[q], b.points[r], k, query_bid=b.bids[q], ref_bid=b.bids[r],
                         ref_mask=b.masks[r])

    want = dict(edges_self=(plain(0, 0, 8), plain(1, 1, 6)), edges_forward=(plain(1, 0, 5),),
                edges_propagate=(plain(0, 1, 4),))
    for name, sets in want.items():
        assert all(torch.equal(a, b) for a, b in zip(getattr(got, name), sets)), name


def test_compute_knn_packed_refuses_an_unknown_method():
    from pcf_torch.data import post_knn

    with pytest.raises(ValueError, match="unknown method 'nearest'"):
        post_knn.compute_knn_packed(_pyramid_without_edges(), (2, 2), (2, 2), (2, 2),
                                    method="nearest")
