"""The device pyramid of pcf_torch (ops/subsample.grid_subsample_fixed,
core/batching.pack_scenes without edges, data/post_knn.py, the dataset's
post_knn and device_pyramid items and loaders) against pcf_tpu's on the same
seeded inputs, on the CPU: the subsampling field for field, bit for bit;
the packed batches field for field; the kNN edges with distances at 1e-6
relative and indices equal wherever the distances are distinct (pcf_tpu's
kNN called with method="exact"); the model's logits on a device-prepared
batch at 5e-3 / 1e-3, with pcf_tpu's weights carried over."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu import config as j_config
from pcf_tpu.core.batching import pack_scenes as j_pack
from pcf_tpu.data import post_knn as j_post
from pcf_tpu.data import scannet as j_scannet
from pcf_tpu.data.synthetic import synthetic_scene
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.ops.subsample import grid_subsample_fixed as j_subsample

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch import config as t_config
from pcf_torch.convert import load_jax_variables
from pcf_torch.core.batching import pack_scenes as t_pack
from pcf_torch.data import post_knn as t_post
from pcf_torch.data import scannet as t_scannet
from pcf_torch.entry import build
from pcf_torch.ops.subsample import grid_subsample_fixed as t_subsample
from test_torch_pipeline import _check_batch, _same

GRID = [0.3, 0.6, 1.2]
NCLS = 5
DIST_RTOL = 1e-6
TIE_RTOL = 1e-6
ATOL, RTOL = 5e-3, 1e-3


@pytest.fixture(autouse=True)
def numpy_pyramids(monkeypatch):
    """Both host pyramids on numpy/scipy."""
    monkeypatch.setattr(j_pyramid, "_USE_NATIVE", False)
    monkeypatch.setattr(t_pyramid, "_USE_NATIVE", False)


def _cfgs(**kw):
    """(pcf_tpu cfg, pcf_torch cfg): the same keys, each package's Config."""
    out = []
    for mod in (j_config, t_config):
        cfg = mod.get_default_training_cfgs(mod.get_default_configs(mod.Config(), num_level=3,
                                                                    base_dim=8))
        cfg.update(grid_size=GRID, K_self=[8] * 3, K_forward=[8] * 3, K_propagate=[8] * 3,
                   num_classes=NCLS, BATCH_SIZE=2, knn_method="exact", guided_level=0,
                   num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4])
        cfg.update(kw)
        out.append(cfg)
    return out


def _scenes(levels: bool, n=300, count=2):
    """Items without edges: the host pyramid (post_knn) or level 0 alone
    (device_pyramid)."""
    items = []
    for i in range(count):
        coord, norm, feats, labels = synthetic_scene(n, extent=4.0, num_classes=NCLS, seed=i)
        if levels:
            pl, nl = t_pyramid.subsample(coord, norm, GRID)
        else:
            pl, nl = [coord.astype(np.float32)], [norm.astype(np.float32)]
        items.append({"point_list": pl, "surface_normal_list": nl,
                      "feature_list": feats.astype(np.float32),
                      "label_list": labels.astype(np.int32)})
    return items


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_edges(jb, tb, kinds=("edges_self", "edges_forward", "edges_propagate")):
    """Each edge set: the port's distances within DIST_RTOL of pcf_tpu's over
    the valid query rows, indices equal where the distances are distinct."""
    n = len(jb.points)
    for kind in kinds:
        for lvl, (je, te) in enumerate(zip(getattr(jb, kind), getattr(tb, kind))):
            q_lvl = {"edges_self": lvl, "edges_forward": lvl + 1,
                     "edges_propagate": lvl}[kind]
            r_lvl = {"edges_self": lvl, "edges_forward": lvl,
                     "edges_propagate": lvl + 1}[kind]
            assert r_lvl < n
            m = _np(jb.masks[q_lvl])
            q = _np(jb.points[q_lvl])[m].astype(np.float64)
            r = _np(jb.points[r_lvl]).astype(np.float64)
            je, te = _np(je)[m], _np(te)[m]
            assert te.dtype == np.int32 and te.shape == je.shape
            jd = ((q[:, None] - r[je]) ** 2).sum(-1)
            td = ((q[:, None] - r[te]) ** 2).sum(-1)
            np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=1e-12,
                                       err_msg=f"{kind}[{lvl}]")
            gaps = np.diff(jd, axis=1) > TIE_RTOL * np.maximum(jd[:, 1:], 1e-12)
            distinct = np.ones(jd.shape, bool)
            distinct[:, 1:] &= gaps
            distinct[:, :-1] &= gaps
            np.testing.assert_array_equal(te[distinct], je[distinct], err_msg=f"{kind}[{lvl}]")


# ---- grid_subsample_fixed ---------------------------------------------------

def _subsample_inputs(case):
    rng = np.random.default_rng({"fits": 0, "capacity": 1, "key": 2}[case])
    n, cap, dl = 400, 512, 0.5
    pts = rng.uniform(0, 3, size=(n, 3)).astype(np.float32)
    if case == "capacity":
        cap, dl = 64, 0.1  # about 400 voxels into 64 rows
    if case == "key":
        pts[::2] *= 4000.0  # 12000^3 / 0.5^3 cells: past int32 with the scenes
    lab = rng.integers(-1, NCLS + 1, size=n).astype(np.int32)  # out-of-range labels too
    bid = np.repeat([0, 1], n // 2).astype(np.int32)
    pad = 512 - n
    pts = np.pad(pts, [(0, pad), (0, 0)])
    return dict(points=pts, mask=np.arange(512) < n, sample_dl=dl, capacity=cap,
                features=rng.normal(size=(512, 3)).astype(np.float32),
                labels=np.pad(lab, [(0, pad)], constant_values=-100), num_classes=NCLS,
                bid=np.pad(bid, [(0, pad)], constant_values=-1), n_scenes=2)


@pytest.mark.parametrize("case", ["fits", "capacity", "key"])
def test_grid_subsample_fixed_matches_pcf_tpu(case):
    """Every field bit for bit: points, feats, labels, bid, mask and the
    overflow flag, which capacity overflow and key overflow each raise."""
    kw = _subsample_inputs(case)
    want = j_subsample(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                          for k, v in kw.items()})
    got = t_subsample(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                         for k, v in kw.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        _same(np.asarray(want[k]), got[k])
    assert bool(got["overflow"]) == (case != "fits")
    if case == "capacity":
        assert int(got["mask"].sum()) == 64
    assert got["overflow"].shape == () and got["overflow"].dtype == torch.bool


def test_grid_subsample_fixed_without_optional_inputs():
    kw = _subsample_inputs("fits")
    want = j_subsample(jnp.asarray(kw["points"]), jnp.asarray(kw["mask"]), 0.4, 512)
    got = t_subsample(torch.from_numpy(kw["points"]), torch.from_numpy(kw["mask"]), 0.4, 512)
    for k in ("feats", "labels", "bid"):
        assert want[k] is None and got[k] is None
    for k in ("points", "mask", "overflow"):
        _same(np.asarray(want[k]), got[k])
    with pytest.raises(ValueError, match="num_classes"):
        t_subsample(torch.from_numpy(kw["points"]), torch.from_numpy(kw["mask"]), 0.4, 512,
                    labels=torch.from_numpy(kw["labels"]))


# ---- pack_scenes without edges ---------------------------------------------

@pytest.mark.parametrize("levels", [True, False], ids=["post_knn", "device_pyramid"])
def test_pack_scenes_without_edges_matches_pcf_tpu(levels):
    """[rows, 1] zero placeholders and no windows, even with window_tile; a
    level-0 item list packs to a one-level batch."""
    items = _scenes(levels)
    for kw in ({}, {"window_tile": 16}):
        jb = j_pack(items, bucket_multiple=256, **kw)
        tb = t_pack(items, bucket_multiple=256, **kw)
        _check_batch(jb, tb)
        assert len(tb.points) == (3 if levels else 1)
        for lvl, e in enumerate(tb.edges_self):
            assert e.shape == (tb.points[lvl].shape[0], 1) and not e.any()
        for lvl, e in enumerate(tb.edges_forward):
            assert e.shape == (tb.points[lvl + 1].shape[0], 1)


# ---- post_knn.py -------------------------------------------------------------

def test_compute_knn_packed_matches_pcf_tpu():
    items = _scenes(True)
    jb = j_pack(items, level_caps=[1024, 512, 256])
    tb = t_pack(items, level_caps=[1024, 512, 256])
    ks = ((8, 8, 8), (8, 6, 6), (5, 8, 8))
    jf = j_post.compute_knn_packed(jb, *ks, method="exact")
    tf = t_post.compute_knn_packed(tb, *ks, method="approx")
    for f in ("feats", "labels", "points", "norms", "masks", "bids"):
        assert getattr(tf, f) is getattr(tb, f)
    _check_edges(jf, tf)
    assert [e.shape[1] for e in tf.edges_forward] == [6, 6]
    assert [e.shape[1] for e in tf.edges_propagate] == [5, 8]


def test_build_pyramid_packed_matches_pcf_tpu():
    """Every level's points, masks and bids bit for bit, the normals within
    1e-6, the edges as compute_knn_packed's, the overflow flag False; and
    each scene's voxels those of the host pyramid."""
    items = _scenes(False)
    jb, tb = j_pack(items, level_caps=[1024]), t_pack(items, level_caps=[1024])
    args = (tuple(GRID), (1024, 512, 256), 2, (8,) * 3, (8,) * 3, (8,) * 3)
    jf, jo = j_post.build_pyramid_packed(jb, *args, method="exact")
    tf, to = t_post.build_pyramid_packed(tb, *args)
    assert not bool(to) and not bool(jo)
    for f in ("points", "masks", "bids"):
        for a, b in zip(getattr(jf, f), getattr(tf, f)):
            _same(np.asarray(a), b)
    for a, b in zip(jf.norms, tf.norms):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    _check_edges(jf, tf)
    host = _scenes(True)
    for lvl in (1, 2):
        m = tf.masks[lvl].numpy()
        pts, bid = tf.points[lvl].numpy()[m], tf.bids[lvl].numpy()[m]
        for i in range(2):
            got, want = pts[bid == i], host[i]["point_list"][lvl]
            assert got.shape == want.shape
            np.testing.assert_allclose(got[np.lexsort(got.T)], want[np.lexsort(want.T)],
                                       atol=1e-4)


@pytest.mark.parametrize("configured", [False, True])
def test_device_level_caps_matches_pcf_tpu(configured):
    extra = {"device_level_caps": [4096, 999, 300]} if configured else {}
    for shrink in (None, 1.5):
        jc, tc = _cfgs(**extra, **({} if shrink is None else {"device_cap_shrink": shrink}))
        for cap0 in (256, 4096, 40960):
            assert t_post.device_level_caps(tc, cap0) == j_post.device_level_caps(jc, cap0)


@pytest.mark.parametrize("mode", ["post_knn", "device_pyramid"])
def test_prepare_matches_pcf_tpu(mode):
    jc, tc = _cfgs(**{mode: True, "device_level_caps": [1024, 512, 256]})
    items = _scenes(mode == "post_knn")
    caps = [1024, 512, 256] if mode == "post_knn" else [1024]
    jf = j_post.prepare(j_pack(items, level_caps=caps), jc)
    tf = t_post.prepare(t_pack(items, level_caps=caps), tc)
    assert len(tf.points) == 3
    for f in ("points", "masks", "bids"):
        for a, b in zip(getattr(jf, f), getattr(tf, f)):
            _same(np.asarray(a), b)
    _check_edges(jf, tf)


def test_prepare_raises_on_overflow_unless_the_check_is_off():
    """A level cap too small: prepare raises, as pcf_tpu's does; with
    check_pyramid_overflow off both pass the truncated pyramid on."""
    items = _scenes(False)
    jc, tc = _cfgs(device_pyramid=True, device_level_caps=[1024, 256, 256])
    with pytest.raises(ValueError, match="overflowed"):
        j_post.prepare(j_pack(items, level_caps=[1024]), jc)
    with pytest.raises(ValueError, match="overflowed"):
        t_post.prepare(t_pack(items, level_caps=[1024]), tc)
    prep = t_post.make_prepare(tc)
    with pytest.raises(ValueError, match="overflowed"):
        prep(t_pack(items, level_caps=[1024]), "cpu")
    jc.check_pyramid_overflow = tc.check_pyramid_overflow = False
    jf = j_post.prepare(j_pack(items, level_caps=[1024]), jc)
    tf = prep(t_pack(items, level_caps=[1024]), "cpu")
    assert int(tf.masks[1].sum()) == 256
    for a, b in zip(jf.points, tf.points):
        _same(np.asarray(a), b)
    full, flag = t_post.prepare_flagged(t_pack(items, level_caps=[1024]), tc)
    assert bool(flag)


def test_make_prepare_on_the_cpu_is_prepare():
    """make_prepare's prep on the CPU: the batch moved there and prepared,
    as prepare does, with no graph."""
    _, tc = _cfgs(post_knn=True)
    items = _scenes(True)
    prep = t_post.make_prepare(tc)
    got = prep(t_pack(items, level_caps=[1024, 512, 256]), "cpu")
    want = t_post.prepare(t_pack(items, level_caps=[1024, 512, 256]), tc)
    for a, b in zip(want.tensors(), got.tensors()):
        assert torch.equal(a, b)
    assert prep.graphs.captures == 0 and prep.graphs.replays == 0


# ---- the dataset and its loaders ----------------------------------------------

@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for split, base in (("train", 0), ("val", 50)):
        os.makedirs(d / split)
        for i in range(3):
            coord, norm, feats, labels = synthetic_scene(400, extent=4.0, num_classes=NCLS,
                                                         seed=base + i)
            np.savez(d / split / f"scene{i}.npz", coords=coord,
                     feats=np.concatenate([feats, norm], 1), labels=labels,
                     name=f"{split}_scene{i}")
    return d


def _data_cfgs(scene_dir, **kw):
    return _cfgs(bucket_multiple=256, MAX_POINTS_NUM=100000,
                 train_data_path=str(scene_dir / "train" / "*.npz"),
                 val_data_path=str(scene_dir / "val" / "*.npz"),
                 test_data_path=str(scene_dir / "val" / "*.npz"), **kw)


@pytest.mark.parametrize("mode", ["post_knn", "device_pyramid"])
def test_build_item_matches_pcf_tpu(scene_dir, mode):
    """The items of both modes, for a training and a 'multiple' voting
    dataset: no edges; device_pyramid level 0 alone."""
    jc, tc = _data_cfgs(scene_dir, **{mode: True})
    for split, vox in (("training", "random"), ("validation", "multiple")):
        ji = j_scannet.ScanNetDataset(jc, split, voxelize_mode=vox, seed=0)[1]
        ti = t_scannet.ScanNetDataset(tc, split, voxelize_mode=vox, seed=0)[1]
        ji, ti = (ji, ti) if vox == "random" else (ji[0], ti[0])
        assert sorted(ti) == sorted(ji)
        assert not any(k.startswith("nei_") for k in ti)
        assert len(ti["point_list"]) == (3 if mode == "post_knn" else 1)
        for k, v in ji.items():
            for a, b in (zip(v, ti[k]) if isinstance(v, list) else [(v, ti[k])]):
                _same(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["post_knn", "device_pyramid"])
def test_loaders_with_pinned_caps_match_pcf_tpu(scene_dir, mode):
    """getdataLoaders with pin_level_caps under each mode: the same caps
    (one level for device_pyramid), every batch field for field."""
    jc, tc = _data_cfgs(scene_dir, **{mode: True}, pin_level_caps=True, level_caps_sample=3)
    jtrain, jval, _, _ = j_scannet.getdataLoaders(jc)
    ttrain, tval, _, _ = t_scannet.getdataLoaders(tc)
    assert tc.level_caps == jc.level_caps
    assert len(tc.level_caps) == (3 if mode == "post_knn" else 1)
    jb, tb = list(jtrain) + list(jval), list(ttrain) + list(tval)
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        _check_batch(a, b)


# ---- the model on a device-prepared batch -----------------------------------

def test_logits_on_a_device_pyramid_batch_match_pcf_tpu():
    """pcf_tpu's and the port's device_pyramid preparation of the same
    packed level 0 (the same edges), then each model's eval forward with
    pcf_tpu's initial weights, the fused conv kernels on plain edges."""
    kw = dict(device_pyramid=True, device_level_caps=[1024, 512, 256], USE_PE=True,
              USE_PALLAS_KERNEL=True, fused_min_points=0)
    jc, tc = _cfgs(**kw)
    items = _scenes(False)
    jb = j_post.prepare(j_pack(items, level_caps=[1024]), jc)
    tb = t_post.prepare(t_pack(items, level_caps=[1024]), tc)
    # the same neighbour set on every valid row (exact ties may come in
    # another order; a padding row's edges are arbitrary)
    for kind, q in (("edges_self", 0), ("edges_forward", 1), ("edges_propagate", 0)):
        for lvl, (a, b) in enumerate(zip(getattr(jb, kind), getattr(tb, kind))):
            m = tb.masks[lvl + q].numpy()
            _same(np.sort(np.asarray(a)[m], 1), np.sort(b.numpy()[m], 1))
    jmodel = JSeg(jc)
    args = lambda b: (b.feats, list(b.points), list(b.edges_self), list(b.edges_forward),
                      list(b.edges_propagate), list(b.norms))
    # jitted: pcf_tpu's interpret-mode kernels run eagerly several times slower
    variables = jax.jit(lambda k: jmodel.init(k, *args(jb), masks=list(jb.masks),
                                              train=False))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, *args(jb), masks=list(jb.masks),
                                                     train=False))(variables))
    model = load_jax_variables(build(tc, device="cpu"), variables)
    with torch.no_grad():
        got = model.forward_batch(tb).numpy()
    m = tb.masks[0].numpy()
    assert got.shape == want.shape == (1024, NCLS)
    np.testing.assert_allclose(got[m], want[m], atol=ATOL, rtol=RTOL)
