"""pcf_torch's host pipeline against pcf_tpu's: configs, synthetic scenes,
grid subsampling, Morton order, kNN pyramid, tile windows and packed batches
are bit-identical. pcf_tpu runs its numpy/scipy path (its C++ path matches
only up to voxel order)."""

import glob
import os

import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu import config as j_config
from pcf_tpu.core import batching as j_batching
from pcf_tpu.data.synthetic import synthetic_scene as j_scene
from pcf_tpu.ops import subsample as j_subsample
from pcf_tpu.ops import window as j_window

from pcf_torch import config as t_config
from pcf_torch.core import batching as t_batching
from pcf_torch.data import pyramid as t_pyramid
from pcf_torch.data.synthetic import synthetic_scene as t_scene
from pcf_torch.ops import subsample as t_subsample
from pcf_torch.ops import window as t_window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "pcf_tpu", "configs", "*.yaml")))
GRID = [0.3, 0.6, 1.2]


@pytest.fixture(autouse=True)
def numpy_pyramid(monkeypatch):
    monkeypatch.setattr(j_pyramid, "_USE_NATIVE", False)
    monkeypatch.setattr(t_pyramid, "_USE_NATIVE", False)


def _same(a, b):
    """Bit-identical: a numpy array (pcf_tpu) against a tensor or array."""
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    np.testing.assert_array_equal(a, b)


def _same_edges(a, b):
    if isinstance(a, j_window.WindowedEdges):
        assert isinstance(b, t_window.WindowedEdges)
        for f in ("nei", "window_rows", "localT"):
            _same(getattr(a, f), getattr(b, f))
    else:
        _same(a, b)


@pytest.mark.parametrize("path", YAMLS, ids=[os.path.basename(p) for p in YAMLS])
def test_yaml_configs_load_equal(path):
    over = ["compute_dtype=bfloat16", "a.b=3"]
    assert dict(j_config.load_config(path, over)) == dict(t_config.load_config(path, over))


def test_default_configs_equal():
    j = j_config.get_default_training_cfgs(j_config.get_default_configs(j_config.Config()))
    t = t_config.get_default_training_cfgs(t_config.get_default_configs(t_config.Config()))
    assert dict(j) == dict(t)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_scene_and_subsampling(seed):
    ja, ta = j_scene(700, seed=seed), t_scene(700, seed=seed)
    for a, b in zip(ja, ta):
        _same(a, b)
    coord, norm, _, labels = ja
    for a, b in zip(j_subsample.grid_subsampling(coord, norm, labels, sampleDl=0.4),
                    t_subsample.grid_subsampling(coord, norm, labels, sampleDl=0.4)):
        _same(a, b)
    _same(j_window.morton_codes(coord), t_window.morton_codes(coord))
    _same(j_window.morton_argsort(coord), t_window.morton_argsort(coord))


def test_pyramid_and_knn():
    coord, norm, feats, labels = j_scene(600, extent=4.0, seed=2)
    ja = j_pyramid.subsample_and_knn(coord, norm, GRID, 8, 8, 8,
                                     rng=np.random.default_rng(1), morton=True)
    ta = t_pyramid.subsample_and_knn(coord, norm, GRID, 8, 8, 8,
                                     rng=np.random.default_rng(1), morton=True)
    for la, lb in zip(ja, ta):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            _same(a, b)
    for a, b in zip(j_pyramid.subsample(coord, norm, GRID),
                    t_pyramid.subsample(coord, norm, GRID)):
        for x, y in zip(a, b):
            _same(x, y)
    _same(j_pyramid.compute_knn(coord, coord[:50], 4, dilated_rate=2),
          t_pyramid.compute_knn(coord, coord[:50], 4, dilated_rate=2))


def test_windows():
    rng = np.random.default_rng(0)
    nei = rng.integers(0, 300, size=(64, 8)).astype(np.int32)
    _same_edges(j_window.build_windows(nei, tile=16, window=128),
                t_window.build_windows(nei, tile=16, window=128))
    assert j_window.max_window_uniques(nei, 16) == t_window.max_window_uniques(nei, 16)
    for mod in (j_window, t_window):
        # 256 random edge slots over 300 rows hold ~170 uniques > 128
        with pytest.raises(mod.WindowOverflow):
            mod.build_windows(nei, tile=32, window=128)
        # 60 rows do not tile by 16
        assert mod.build_windows(nei[:60], tile=16, window=128, strict=False) is None


@pytest.mark.parametrize("window_tile", [None, 16])
def test_pack_scenes(window_tile):
    items = []
    for seed in (3, 4):
        coord, norm, feats, labels = j_scene(250, extent=4.0, num_classes=5, seed=seed)
        items.append(j_pyramid.scene_to_item(coord, norm, feats, labels, GRID, 8, 8, 8,
                                             rng=np.random.default_rng(seed),
                                             morton=window_tile is not None))
    kw = dict(bucket_multiple=128, window_tile=window_tile, window_size=128)
    _check_batch(j_batching.pack_scenes(items, **kw), t_batching.pack_scenes(items, **kw))
    assert (j_batching.compute_level_caps([100, 5000, 20000], 4096)
            == t_batching.compute_level_caps([100, 5000, 20000], 4096))


def _check_batch(jb, tb):
    _same(jb.feats, tb.feats)
    _same(jb.labels, tb.labels)
    for f in ("points", "norms", "masks", "bids"):
        assert len(getattr(jb, f)) == len(getattr(tb, f))
        for a, b in zip(getattr(jb, f), getattr(tb, f)):
            _same(a, b)
    for f in ("edges_self", "edges_forward", "edges_propagate"):
        assert len(getattr(jb, f)) == len(getattr(tb, f))
        for a, b in zip(getattr(jb, f), getattr(tb, f)):
            _same_edges(a, b)


def test_flagship_batch_matches_graft_entry():
    """The entry()-size flagship batch (2 x 4000 points, windowed) and its
    config, as __graft_entry__._flagship builds them."""
    from __graft_entry__ import _flagship

    from pcf_torch.entry import flagship_batch

    jcfg, jb = _flagship(level0_points=4000, bucket=1024, window_gather=True)
    tcfg, tb = flagship_batch(level0_points=4000, bucket=1024, window_gather=True,
                              device="cpu")
    assert dict(jcfg) == dict(tcfg)
    _check_batch(jb, tb)
