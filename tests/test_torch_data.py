"""pcf_torch's ScanNet data pipeline against pcf_tpu's on the same inputs:
voxelize, the transforms, the native library, scene files, class weights,
level caps and window sizes, prepare, and the loaders, whose packed batches
are bit-identical for the same files, seed and epoch, with both sides on the
numpy/scipy pyramid and, where g++ builds the native library, both on it."""

import importlib
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu import config as j_config
from pcf_tpu import native as j_native
from pcf_tpu.data import prepare as j_prepare
from pcf_tpu.data import scannet as j_scannet
from pcf_tpu.data import transforms as j_T
from pcf_tpu.data.synthetic import synthetic_scene

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch import config as t_config
from pcf_torch import native as t_native
from pcf_torch.data import prepare as t_prepare
from pcf_torch.data import scannet as t_scannet
from pcf_torch.data import transforms as t_T
from test_torch_pipeline import _check_batch, _same

# both packages' ops/__init__ export the function `voxelize` under the module's name
j_vox = importlib.import_module("pcf_tpu.ops.voxelize")
t_vox = importlib.import_module("pcf_torch.ops.voxelize")

GRID = [0.35, 0.7, 1.4]
NCLS = 5
# every augmentation of the training split on
AUGMENT = dict(rotate_aug=True, flip_aug=True, scale_aug=True, transform_aug=True,
               color_aug=True, crop=True, shuffle_index=True, mix3D=True,
               noisy_points=True, noise_level=0.1, noise_pct=0.1)


@pytest.fixture(params=["numpy", "native"])
def pyramid(request, monkeypatch):
    """Both pyramids on one path: numpy/scipy, or the native library."""
    use = request.param == "native"
    if use and not (j_native.is_available() and t_native.is_available()):
        pytest.skip("g++ is missing: the native library cannot be built here")
    monkeypatch.setattr(j_pyramid, "_USE_NATIVE", use)
    monkeypatch.setattr(t_pyramid, "_USE_NATIVE", use)
    return request.param


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """3 + 3 small scenes, as tests/test_pipeline.py's fixture writes them."""
    d = tmp_path_factory.mktemp("scannet_like")
    for split, base in (("train", 0), ("val", 50)):
        os.makedirs(d / split)
        for i in range(3):
            coord, norm, feats, labels = synthetic_scene(400, extent=4.0, num_classes=NCLS,
                                                         seed=base + i)
            np.savez(d / split / f"scene{i}.npz", coords=coord,
                     feats=np.concatenate([feats, norm], 1), labels=labels,
                     name=f"{split}_scene{i}")
    return d


def _cfgs(scene_dir, **kw):
    """(pcf_tpu cfg, pcf_torch cfg): the same keys, each package's Config."""
    out = []
    for mod in (j_config, t_config):
        cfg = mod.get_default_training_cfgs(mod.get_default_configs(mod.Config(), num_level=3,
                                                                    base_dim=8))
        cfg.update(grid_size=GRID, num_classes=NCLS, BATCH_SIZE=2, bucket_multiple=256,
                   MAX_POINTS_NUM=100000, K_self=[8] * 3, K_forward=[8] * 3,
                   K_propagate=[8] * 3,
                   train_data_path=str(scene_dir / "train" / "*.npz"),
                   val_data_path=str(scene_dir / "val" / "*.npz"),
                   test_data_path=str(scene_dir / "val" / "*.npz"))
        cfg.update(kw)
        out.append(cfg)
    return out


# ---- voxelize and transforms -----------------------------------------------

@pytest.mark.parametrize("mode", ["random", "deterministic", "multiple"])
def test_voxelize(mode):
    coord = np.random.default_rng(0).uniform(0, 2, (3000, 3)).astype(np.float32)
    _same(j_vox.voxel_cell_ids(coord, 0.2), t_vox.voxel_cell_ids(coord, 0.2))
    a = j_vox.voxelize(coord, 0.2, mode=mode, rng=np.random.default_rng(3))
    b = t_vox.voxelize(coord, 0.2, mode=mode, rng=np.random.default_rng(3))
    if mode == "multiple":
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            _same(x, y)
    else:
        _same(a, b)


TRANSFORMS = {
    "RandomDropColor": dict(p=0.5, color_augment=0.3),
    "RandomDropout": dict(dropout_ratio=0.3, dropout_application_ratio=0.5),
    "RandomHorizontalFlip": dict(upright_axis="z", apply_likelihood=0.9),
    "ChromaticTranslation": dict(trans_range_ratio=0.2, apply_likelihood=0.8),
    "ChromaticAutoContrast": dict(),
    "ChromaticJitter": dict(std=0.02, apply_likelihood=0.8),
    "NoisyPoints": dict(noise_level=0.1, noise_pct=0.2),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform(name):
    """Each transform, chained with Compose, over 12 draws of one seeded
    Generator per side (both branches of every probability)."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    feats = rng.uniform(0, 255, (500, 3)).astype(np.float32)
    labels = rng.integers(0, NCLS, 500).astype(np.int64)
    norms = rng.normal(size=(500, 3)).astype(np.float32)
    outs = []
    for T in (j_T, t_T):
        t = T.Compose([getattr(T, name)(rng=np.random.default_rng(11), **TRANSFORMS[name])])
        outs.append([t(coords.copy(), feats.copy(), labels.copy(), norms.copy())
                     for _ in range(12)])
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            _same(x, y)


def test_elastic_distortion_and_transformation_matrix():
    pc = np.random.default_rng(1).uniform(0, 2, (400, 6)).astype(np.float32)
    _same(j_T.elastic_distortion(pc.copy(), 0.2, 0.4, rng=np.random.default_rng(2)),
          t_T.elastic_distortion(pc.copy(), 0.2, 0.4, rng=np.random.default_rng(2)))
    _same(j_T.rotation_matrix(1, 0.3), t_T.rotation_matrix(1, 0.3))
    bounds = ((-0.1, 0.1), (-0.1, 0.1), (-np.pi, np.pi))
    for angle in (None, 0.7):
        for a, b in zip(j_T.get_transformation_matrix(bounds, (0.9, 1.1), angle,
                                                      rng=np.random.default_rng(4)),
                        t_T.get_transformation_matrix(bounds, (0.9, 1.1), angle,
                                                      rng=np.random.default_rng(4))):
            _same(a, b)


# ---- the native library -----------------------------------------------------

def test_native_library_matches_pcf_tpus():
    if not (j_native.is_available() and t_native.is_available()):
        pytest.skip("g++ is missing: the native library cannot be built here")
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 3, (5000, 3)).astype(np.float32)
    feats = rng.normal(size=(5000, 4)).astype(np.float32)
    labels = rng.integers(0, 7, 5000).astype(np.int32)
    for a, b in zip(j_native.grid_subsample(pts, feats, labels, 0.25),
                    t_native.grid_subsample(pts, feats, labels, 0.25)):
        _same(a, b)
    _same(j_native.grid_subsample(pts, sample_dl=0.3),
          t_native.grid_subsample(pts, sample_dl=0.3))
    _same(j_native.knn(pts, pts[:700], 8), t_native.knn(pts, pts[:700], 8))
    _same(j_native.knn_batch(pts, pts, [3000, 2000], [3000, 2000], 5),
          t_native.knn_batch(pts, pts, [3000, 2000], [3000, 2000], 5))
    assert str(t_native.BUILD_DIR).endswith(os.path.join("pcf_torch", "_build"))
    assert t_native.library_path("g++").parent == t_native.BUILD_DIR


def test_flagship_batch_follows_the_host_pyramid(pyramid):
    """The flagship workload takes the host's pyramid path, as
    __graft_entry__'s does: on numpy/scipy and on native it equals pcf_tpu's
    on the same path."""
    from __graft_entry__ import _flagship

    from pcf_torch.entry import flagship_batch

    _, jb = _flagship(level0_points=4000, bucket=1024, window_gather=True)
    _, tb = flagship_batch(level0_points=4000, bucket=1024, window_gather=True, device="cpu")
    _check_batch(jb, tb)


# ---- scene files, class weights, caps and windows ----------------------------

def test_load_scene_file_npz_and_pth(tmp_path):
    coord, norm, feats, labels = synthetic_scene(300, extent=3.0, num_classes=NCLS, seed=9)
    full = np.concatenate([feats, norm], 1)
    np.savez(tmp_path / "s.npz", coords=coord, feats=full, labels=labels, name="s_npz")
    torch.save((coord, full, labels.astype(np.int64), "s_pth"), tmp_path / "s.pth")
    np.savez(tmp_path / "color_only.npz", coords=coord, feats=feats)
    for name in ("s.npz", "s.pth", "color_only.npz"):
        a = j_scannet.load_scene_file(str(tmp_path / name))
        b = t_scannet.load_scene_file(str(tmp_path / name))
        for x, y in zip(a[:4], b[:4]):
            _same(x, y)
        assert a[4] == b[4]
    _same(b[0], coord)
    assert t_scannet.load_scene_file(str(tmp_path / "s.pth"))[4] == "s_pth"


def test_compute_weight():
    rng = np.random.default_rng(5)
    labels = [rng.integers(-1, 7, 400) for _ in range(3)]
    assert j_scannet.compute_weight(labels, 8) == t_scannet.compute_weight(labels, 8)


def test_estimate_level_caps_and_window_sizes(scene_dir, pyramid):
    jc, tc = _cfgs(scene_dir, window_gather=True, **AUGMENT)
    jds = [j_scannet.ScanNetDataset(jc, s, seed=1) for s in ("training", "validation")]
    tds = [t_scannet.ScanNetDataset(tc, s, seed=1) for s in ("training", "validation")]
    assert jc.weights == tc.weights
    assert (j_scannet.estimate_level_caps(jds, 2, 256, sample=3, margin=1.1, seed=4)
            == t_scannet.estimate_level_caps(tds, 2, 256, sample=3, margin=1.1, seed=4))
    assert (j_scannet.estimate_window_sizes(jds, sample=3, seed=4)
            == t_scannet.estimate_window_sizes(tds, sample=3, seed=4))


# ---- the loaders ------------------------------------------------------------

def _epochs(mod, cfg, epochs=2):
    """Every batch of both loaders of getdataLoaders over `epochs` epochs,
    and the window-overflow warnings raised meanwhile."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train, val, _, _ = mod.getdataLoaders(cfg)
        out = []
        for epoch in range(epochs):
            train.set_epoch(epoch)
            out.append(list(train))
            out.append(list(val))
    return out, sum("window overflow" in str(w.message) for w in caught)


@pytest.mark.parametrize("policy", ["drop", "plain"])
@pytest.mark.parametrize("workers", [0, 2])
def test_loaders_bit_identical(scene_dir, pyramid, workers, policy):
    """getdataLoaders over two epochs with every augmentation on, pinned
    level caps, and windows small enough that some scenes overflow (their
    batch re-packed under `policy`): every batch equal to pcf_tpu's, field
    by field."""
    jc, tc = _cfgs(scene_dir, window_gather=True, pin_level_caps=True, level_caps_sample=3,
                   level_caps_margin=2.0, window_sizes=(256, 256, 256),
                   window_overflow=policy, NUM_WORKERS=workers, **AUGMENT)
    jb, j_over = _epochs(j_scannet, jc)
    tb, t_over = _epochs(t_scannet, tc)
    assert tc.level_caps == jc.level_caps and tc.weights == jc.weights
    assert j_over == t_over > 0  # the overflow policy ran
    assert [len(b) for b in jb] == [len(b) for b in tb]
    assert sum(len(b) for b in tb) >= 4
    for jl, tl in zip(jb, tb):
        for a, b in zip(jl, tl):
            _check_batch(a, b)


def test_getdataLoadersDDP_takes_rank_zero_of_one(scene_dir):
    _, tc = _cfgs(scene_dir)
    train, val = t_scannet.getdataLoadersDDP(tc)
    assert (train.process_index, train.process_count) == (0, 1)
    assert len(list(val)) == 2


def test_unported_device_pyramid_raises(scene_dir):
    for key in ("post_knn", "device_pyramid"):
        _, tc = _cfgs(scene_dir, **{key: True})
        ds = t_scannet.ScanNetDataset(tc, "validation", seed=0)
        with pytest.raises(NotImplementedError, match="post_knn"):
            ds[0]


def test_abandoned_loader_releases_producer_thread(scene_dir):
    """Breaking off an iteration must not leak the producer thread blocked in
    its queue put (the port of tests/test_pipeline.py's test)."""
    _, tc = _cfgs(scene_dir)
    ds = t_scannet.ScanNetDataset(tc, "training", seed=0)
    loader = t_scannet.PackedLoader(ds, batch_size=1, bucket_multiple=256, seed=0,
                                    prefetch=1, drop_last=False)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


# ---- prepare ---------------------------------------------------------------

def _write_ply(path, verts, colors=None, labels=None, faces=None, binary=True):
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if labels is not None:
        props += [("label", "<u2")]
    tname = {"<f4": "float", "u1": "uchar", "<u2": "ushort"}
    head = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
            f"element vertex {len(verts)}"]
    head += [f"property {tname[t]} {n}" for n, t in props]
    if faces is not None:
        head += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    head.append("end_header")
    rec = np.zeros(len(verts), dtype=props)
    rec["x"], rec["y"], rec["z"] = verts.T
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors.T
    if labels is not None:
        rec["label"] = labels
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
            if faces is not None:
                face = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
                face["n"], face["v"] = 3, faces
                f.write(face.tobytes())
        else:
            for r in rec:
                f.write((" ".join(str(v) for v in r) + "\n").encode("ascii"))
            for tri in faces if faces is not None else ():
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))


def test_prepare_process_scene(tmp_path):
    """A mesh (binary PLY) and its labels (ASCII PLY) to the same .npz
    contents as pcf_tpu's prepare."""
    rng = np.random.default_rng(3)
    scene = "scene0000_00"
    os.makedirs(tmp_path / "scans" / scene)
    verts = rng.uniform(0, 2, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (90, 3)).astype(np.int32)
    colors = rng.integers(0, 256, (60, 3)).astype(np.uint8)
    _write_ply(tmp_path / "scans" / scene / f"{scene}_vh_clean_2.ply", verts, colors,
               faces=faces)
    _write_ply(tmp_path / "scans" / scene / f"{scene}_vh_clean_2.labels.ply", verts,
               labels=rng.integers(0, 45, 60), binary=False)
    got = {}
    for side, mod in (("j", j_prepare), ("t", t_prepare)):
        os.makedirs(tmp_path / side)
        assert mod.process_scene(str(tmp_path / "scans"), scene, str(tmp_path / side)) == scene
        got[side] = dict(np.load(tmp_path / side / f"{scene}.npz"))
    assert sorted(got["j"]) == sorted(got["t"]) == ["coords", "feats", "labels", "name"]
    for k in got["j"]:
        _same(got["j"][k], got["t"][k])
    assert (got["t"]["labels"] >= 0).any() and (got["t"]["labels"] == -100).any()
