"""Inputs from the seed: the same seed gives the same rooms and weights;
every seed gets the same set of rooms, in its own order."""

import numpy as np
import torch

from perfbench import harness, weights


def test_same_seed_same_rooms_and_weights(tiny):
    cell = tiny("pcf10_train_hostknn")
    a, sa = harness.rooms(cell, 2 ** 31 + 11)
    b, sb = harness.rooms(cell, 2 ** 31 + 11)
    assert sa == sb
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    wa = weights.draw(cell.cfg, 2 ** 31 + 11, "cpu")
    wb = weights.draw(cell.cfg, 2 ** 31 + 11, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    wc = weights.draw(cell.cfg, 2 ** 31 + 12, "cpu")
    assert not torch.equal(wa["fc2.weight"], wc["fc2.weight"])


def test_seeds_share_the_room_set(tiny):
    cell = tiny("flagship_eval")
    a, sa = harness.rooms(cell, 1)
    b, sb = harness.rooms(cell, 2)
    assert sorted(sa) == sorted(sb)
    by_seed = {s: r for s, r in zip(sb, b)}
    for s, r in zip(sa, a):
        assert np.array_equal(r[0], by_seed[s][0])


def test_weights_fill_every_program_parameter(tiny):
    from pcf_torch.config import Config, get_default_configs, get_default_training_cfgs
    from pcf_torch.models import PointConvFormer_Segmentation

    cell = tiny("flagship_eval")
    cfg = get_default_training_cfgs(get_default_configs(Config.from_dict(cell.cfg), 3, 32))
    model = PointConvFormer_Segmentation(cfg)
    w = weights.draw(cell.cfg, 5, "cpu")
    mapping = weights.to_program(w, model)
    assert len(mapping) == len(list(model.parameters()))
    assert any(t for _, t in mapping.values())  # the fused layers' transposed linears


def test_level0_keeps_one_point_per_voxel():
    from perfbench.rooms import level0, make_room

    coord, color, norm, label = make_room(3, 4000, 20)
    c, col, n, lab = level0(coord, color, norm, label, 0.1)
    cells = np.floor(c / 0.1).astype(np.int64)
    assert len(np.unique(cells, axis=0)) == c.shape[0] < coord.shape[0]
    assert c.min() >= 0 and lab.max() < 20 and col.shape == n.shape == c.shape
