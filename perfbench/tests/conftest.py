"""The benchmark's own tests (python3 -m pytest perfbench/tests): CPU tests
at a tiny size, and tests marked `gpu` that need the card and skip without
one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def shrink(cell):
    """The cell at a size a CPU test holds: 3 levels, narrow widths, two
    batches of two rooms of 1,500 points, 8 classes."""
    cfg = dict(cell.meta["config"])
    cfg.update(num_level=3, feat_dim=[32, 64, 96], base_dim=32, mid_dim=[16] * 3,
               resblocks=[0, 1, 1], resblocks_back=[0] * 3, grid_size=[0.1, 0.2, 0.4],
               K_self=[16] * 3, K_forward=[16] * 3, K_propagate=[16] * 3, BATCH_SIZE=2,
               bucket_multiple=512, num_classes=8)
    cell.meta = dict(cell.meta, config=cfg)
    cell.traffic = dict(cell.traffic, room_points=1500, pool_batches=2,
                        calibration_passes=2, trace_steps=3)
    return cell


@pytest.fixture
def tiny():
    from perfbench import harness

    return lambda name: shrink(harness.find_cell(name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
