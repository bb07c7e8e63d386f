"""pcf_torch.eval.voting against pcf_tpu.eval.voting on the CPU: the chunking
of covering sets, the device pyramid's caps from the batch-global-origin
cascade, the overflow flag read after the check, and evaluate_voting itself
on one small scene with two votes for the host pyramid, post_knn and
device_pyramid: the same mIoU and every <scene>_probs.npy within 1e-4, with
pcf_tpu's initial weights carried over (both pyramids on numpy/scipy, kNN
exact)."""

import os

import jax
import numpy as np
import pytest
import torch

import pcf_tpu.data.pyramid as j_pyramid
from pcf_tpu import config as j_config
from pcf_tpu.core.batching import pack_scenes as j_pack
from pcf_tpu.data.scannet import ScanNetDataset as JDataset
from pcf_tpu.data.synthetic import synthetic_scene
from pcf_tpu.eval.voting import _chunk_item as j_chunk_item
from pcf_tpu.eval.voting import evaluate_voting as j_voting
from pcf_tpu.models import PointConvFormer_Segmentation as JSeg
from pcf_tpu.train.state import create_train_state as j_state
from pcf_tpu.train.state import make_optimizer as j_optimizer

import pcf_torch.data.pyramid as t_pyramid
from pcf_torch import config as t_config
from pcf_torch.convert import load_jax_variables
from pcf_torch.core.batching import pack_scenes as t_pack
from pcf_torch.data import post_knn as t_post
from pcf_torch.entry import build
from pcf_torch.eval import voting as t_voting
from pcf_torch.ops.subsample import grid_subsampling

GRID = [0.35, 0.7, 1.4]
NCLS = 5
PROBS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def numpy_pyramids(monkeypatch):
    monkeypatch.setattr(j_pyramid, "_USE_NATIVE", False)
    monkeypatch.setattr(t_pyramid, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for split, base in (("train", 0), ("val", 50)):
        os.makedirs(d / split)
        for i in range(2):
            coord, norm, feats, labels = synthetic_scene(400, extent=4.0, num_classes=NCLS,
                                                         seed=base + i)
            np.savez(d / split / f"scene{i}.npz", coords=coord,
                     feats=np.concatenate([feats, norm], 1), labels=labels,
                     name=f"{split}_scene{i}")
    return d


def _cfg(mod, scene_dir, **kw):
    cfg = mod.get_default_training_cfgs(mod.get_default_configs(mod.Config(), num_level=3,
                                                                base_dim=8))
    cfg.update(guided_level=0, num_heads=2, resblocks=[0, 1, 1], mid_dim=[4, 4, 4],
               grid_size=GRID, num_classes=NCLS, BATCH_SIZE=2, bucket_multiple=256,
               MAX_POINTS_NUM=100000, K_self=[8] * 3, K_forward=[8] * 3, K_propagate=[8] * 3,
               knn_method="exact", eval_workers=2,
               train_data_path=str(scene_dir / "train" / "*.npz"),
               val_data_path=str(scene_dir / "val" / "*.npz"),
               test_data_path=str(scene_dir / "val" / "*.npz"))
    cfg.update(kw)
    return cfg


# ---- _chunk_item and the cascade caps -----------------------------------------

@pytest.mark.parametrize("max_points", [1000, 300, 128, 7])
def test_chunk_item_matches_pcf_tpu(max_points):
    n = 300
    item = {"point_list": [np.zeros((n, 3), np.float32)],
            "crop_idx": np.random.default_rng(0).permutation(1000)[:n], "tag": "x"}
    want, got = j_chunk_item(item, max_points), t_voting._chunk_item(item, max_points)
    assert len(got) == len(want) == -(-n // max_points)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["crop_idx"], b["crop_idx"])
        assert a.get("_slice") == b.get("_slice")
    assert np.array_equal(np.concatenate([c["crop_idx"] for c in got]), item["crop_idx"])


def _level0_items(offsets):
    items = []
    for i, off in enumerate(offsets):
        coord, norm, feats, labels = synthetic_scene(400, extent=4.0, num_classes=NCLS, seed=i)
        items.append({"point_list": [(coord + np.float32(off)).astype(np.float32)],
                      "surface_normal_list": [norm.astype(np.float32)],
                      "feature_list": feats.astype(np.float32),
                      "label_list": labels.astype(np.int32)})
    return items


def _bucket(n):
    return int(-(-(n + 128) // 512) * 512)


def test_cascade_caps_one_scene_is_the_host_cascade():
    """One scene (vote_batch 1): its own host grid_subsampling cascade, as
    pcf_tpu counts it."""
    items = _level0_items([0.0])
    caps = t_voting._cascade_caps(t_pack(items, level_caps=[512]), GRID)
    cur, want = items[0]["point_list"][0], [512]
    for g in GRID[1:]:
        cur = grid_subsampling(cur, sampleDl=g)
        want.append(_bucket(cur.shape[0]))
    assert caps == tuple(want)


def test_cascade_caps_count_from_the_batch_global_origin():
    """Several scenes in one batch: the counts are the device pyramid's,
    which voxelizes every scene from one batch-global origin, so the caps
    fit build_pyramid_packed's levels with the slack to spare."""
    items = _level0_items([0.0, 0.13, 2.71])
    batch = t_pack(items, level_caps=[2048])
    caps = t_voting._cascade_caps(batch, GRID)
    full, overflow = t_post.build_pyramid_packed(batch, tuple(GRID), (2048, 2048, 2048), 3,
                                                 (8,) * 3, (8,) * 3, (8,) * 3)
    assert not bool(overflow)
    assert caps[0] == 2048
    for lvl in (1, 2):
        assert caps[lvl] == _bucket(int(full.masks[lvl].sum())), lvl


# ---- evaluate_voting ---------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(scene_dir):
    """pcf_tpu's initial variables (BN statistics moved off their start)."""
    cfg = _cfg(j_config, scene_dir)
    batch = j_pack([JDataset(cfg, "validation", seed=0)[0]], bucket_multiple=256)
    model = JSeg(cfg)
    variables = jax.jit(lambda k: model.init(
        k, batch.feats, list(batch.points), list(batch.edges_self),
        list(batch.edges_forward), list(batch.edges_propagate), list(batch.norms),
        masks=list(batch.masks), train=False))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.default_rng(0)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


@pytest.mark.parametrize("mode", ["host", "post_knn", "device_pyramid"])
def test_evaluate_voting_matches_pcf_tpu(scene_dir, weights, tmp_path, mode):
    kw = {} if mode == "host" else {mode: True}
    jc = _cfg(j_config, scene_dir, eval_path=str(tmp_path / "j"), **kw)
    tc = _cfg(t_config, scene_dir, eval_path=str(tmp_path / "t"), **kw)
    tx, _ = j_optimizer(jc, 1)
    j_miou = j_voting(jc, state=j_state(weights, tx), vote_num=2, max_scenes=1)
    model = load_jax_variables(build(tc, device="cpu"), weights)
    t_miou = t_voting.evaluate_voting(tc, state=model, vote_num=2, max_scenes=1)
    assert t_miou == pytest.approx(j_miou, abs=1e-12)
    names = sorted(os.listdir(tmp_path / "j"))
    assert [n for n in names if n != "log.txt"] == [
        "val_scene0.ply", "val_scene0.txt", "val_scene0_probs.npy"]
    jp, tp = (np.load(tmp_path / s / "val_scene0_probs.npy") for s in "jt")
    assert tp.shape == jp.shape == (400, NCLS)
    np.testing.assert_allclose(tp, jp, atol=PROBS_ATOL, rtol=0)
    top2 = np.sort(jp, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > PROBS_ATOL
    jl, tl = (np.loadtxt(tmp_path / s / "val_scene0.txt", dtype=np.int64) for s in "jt")
    np.testing.assert_array_equal(tl[sure], jl[sure])
    log = (tmp_path / "t" / "log.txt").read_text()
    assert "Voting wall" in log and "Voting mIoU (2 votes)" in log


def test_overflow_flag_is_read_after_the_check(scene_dir, tmp_path):
    """Pinned caps too small for the covering sets: with
    check_pyramid_overflow on, the first drain raises before any output is
    written; with it off, the votes are kept and a warning is logged."""
    tc = _cfg(t_config, scene_dir, device_pyramid=True, device_level_caps=[256, 64, 64],
              eval_path=str(tmp_path / "on"))
    model = build(tc, device="cpu")
    with pytest.raises(ValueError, match="overflowed"):
        t_voting.evaluate_voting(tc, state=model, vote_num=1, max_scenes=1)
    assert not [n for n in os.listdir(tmp_path / "on") if n != "log.txt"]
    tc.update(check_pyramid_overflow=False, eval_path=str(tmp_path / "off"))
    miou = t_voting.evaluate_voting(tc, state=model, vote_num=1, max_scenes=1)
    assert 0.0 <= miou <= 1.0
    assert (tmp_path / "off" / "val_scene0_probs.npy").exists()
    assert "check_pyramid_overflow is off" in (tmp_path / "off" / "log.txt").read_text()


def test_evaluate_voting_defaults_to_the_card(scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tc = _cfg(t_config, scene_dir, eval_path=str(tmp_path / "e"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_voting.evaluate_voting(tc, vote_num=1, max_scenes=1)
