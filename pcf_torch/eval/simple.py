"""Simple (single-pass) ScanNet evaluation with per-scene timing, the port of
pcf_tpu/eval/simple.py.

Rebuild of test_ScanNet_simple.py: restores a checkpoint, runs each scene
once through the eval step of parallel/mesh.make_eval_step (the running BN
statistics; with cfg.fused_eval every Linear+BN pair folded and each conv
layer one launch of the whole-layer kernel, as the reference fuses BN at
test_ScanNet_simple.py:139-142), times it, and writes softmax probs (.npy),
colored predictions (.ply), benchmark label files (.txt) and the class-IoU
log. Scenes are packed one at a time, under no level caps; under
cfg.post_knn or cfg.device_pyramid each is completed on the device
(data/post_knn.make_prepare) before the timed call, and not windowed.

Timing: the first call of a batch signature runs eagerly and captures the
step's CUDA graph (the warm call, like pcf_tpu's compile); the scene's time
is then one more call, a replay on the card, ended by
torch.cuda.synchronize() (utils/timing.py's protocol with one call).

Usage:
  python -m pcf_torch.eval.simple --config <yaml> --pretrain_path <exp>/model
      [--split validation] [--set KEY=VALUE ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pcf_torch.utils.logger import get_logger


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(cfg, pretrain_path: str | None = None, split: str = "validation",
             state=None, max_scenes: int | None = None, write_outputs: bool = True,
             device=None):
    """(mIoU, mean seconds per scene) of cfg's model over `split`.

    The model is `state`'s (a TrainState or a model; evaluated where it
    lies), or else one built from cfg on `device` ("cuda" by default,
    raising without a card) with the weights and BN statistics of the
    latest checkpoint under `pretrain_path` (CheckpointManager.restore_eval;
    random weights without one). Outputs go to cfg.eval_path."""
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.post_knn import make_prepare
    from pcf_torch.data.scannet import ScanNetDataset, estimate_window_sizes
    from pcf_torch.entry import build, resolve_device
    from pcf_torch.eval.io import write_labels_txt, write_ply_color
    from pcf_torch.ops.window import WindowOverflow
    from pcf_torch.parallel.mesh import make_eval_step
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.train.metrics import intersection_and_union
    from pcf_torch.utils.cache import enable_compile_cache

    if state is not None:
        model = getattr(state, "model", state)
        device = next(model.parameters()).device
    else:
        model, device = None, resolve_device(device)
    enable_compile_cache(device)

    eval_dir = cfg.get("eval_path", "./experiments/eval_torch/evaluation")
    os.makedirs(eval_dir, exist_ok=True)
    logger = get_logger(eval_dir)

    dataset = ScanNetDataset(cfg, split=split, seed=cfg.manual_seed)
    if cfg.get("window_gather") and not cfg.get("window_sizes"):
        # derived exactly as getdataLoaders derives them for training
        cfg.window_sizes = estimate_window_sizes(
            [dataset], sample=cfg.get("level_caps_sample", 16),
            margin=cfg.get("window_margin", 1.3),
            tile=cfg.get("window_tile", 128), seed=cfg.manual_seed)
        logger.info(f"derived window_sizes {tuple(cfg.window_sizes)}")
    if model is None:
        model = build(cfg, device, seed=0)
        if pretrain_path:
            # optimizer-independent restore: eval must not care how the
            # checkpoint's optimizer state was shaped
            params, stats, ep = CheckpointManager(pretrain_path).restore_eval()
            if params is None:
                raise FileNotFoundError(f"no checkpoint found at {pretrain_path}")
            model.load_state_dict({**params, **stats})
            logger.info(f"restored checkpoint from {pretrain_path} (epoch {ep})")
    eval_step = make_eval_step(cfg)
    # the pyramid and edges completed on the device (the dataset ships no
    # host edges): windowing, which tiles host edges, is off
    prepare = (make_prepare(cfg) if cfg.get("post_knn") or cfg.get("device_pyramid")
               else None)

    sums = np.zeros((3, cfg.num_classes))  # intersection, union, target
    times = []
    n = len(dataset) if max_scenes is None else min(max_scenes, len(dataset))
    for idx in range(n):
        item = dataset[idx]

        def pack(window_tile):
            return pack_scenes([item], bucket_multiple=cfg.bucket_multiple,
                               ignore_label=cfg.ignore_label, window_tile=window_tile,
                               window_sizes=cfg.get("window_sizes"))

        try:
            batch = pack(cfg.get("window_tile", 128)
                         if cfg.get("window_gather") and prepare is None else None)
        except WindowOverflow as e:  # a rare outlier scene: degrade, not die
            logger.warning(f"window overflow on scene {idx} ({e}); "
                           "falling back to plain edges")
            batch = pack(None)
        if prepare is not None:
            batch = prepare(batch, device)

        eval_step(model, batch)  # warm: this signature's eager run and capture
        _sync(device)
        t0 = time.perf_counter()
        logits = eval_step(model, batch)
        _sync(device)
        times.append(time.perf_counter() - t0)

        valid = batch.masks[0].cpu().numpy()
        probs = torch.softmax(logits.float(), -1).cpu().numpy()[valid]
        pred = probs.argmax(-1)
        labels = batch.labels.cpu().numpy()[valid]
        hists = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(labels),
                                       cfg.num_classes, cfg.ignore_label)
        for i, h in enumerate(hists):
            sums[i] += h.numpy()

        name = os.path.basename(str(dataset.scene_name(idx)))
        if write_outputs:
            np.save(os.path.join(eval_dir, f"{name}_probs.npy"), probs)
            write_ply_color(os.path.join(eval_dir, f"{name}.ply"),
                            batch.points[0].cpu().numpy()[valid], pred)
            write_labels_txt(os.path.join(eval_dir, f"{name}.txt"), pred)
        logger.info(f"{idx + 1}/{n} {name}: {times[-1] * 1000:.1f}ms, "
                    f"{int(valid.sum())} pts")

    iou = sums[0] / np.maximum(sums[1], 1)
    miou = float(iou.mean())
    logger.info(f"Average running time per frame: {np.mean(times):.4f}s")
    logger.info(f"mIoU: {miou:.4f}")
    for c in range(cfg.num_classes):
        cname = cfg.get("classes", [str(i) for i in range(cfg.num_classes)])[c]
        logger.info(f"Class {cname}: iou {iou[c]:.4f}")
    return miou, np.mean(times)


if __name__ == "__main__":
    from pcf_torch.config import load_config

    p = argparse.ArgumentParser("pcf_torch simple eval")
    p.add_argument("--config", required=True)
    p.add_argument("--pretrain_path", default=None)
    p.add_argument("--split", default="validation")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    a = p.parse_args()
    evaluate(load_config(a.config, a.overrides), a.pretrain_path, a.split, device=a.device)
