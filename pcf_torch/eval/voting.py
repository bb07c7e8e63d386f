"""Voting (test-time augmentation) ScanNet evaluation, the port of
pcf_tpu/eval/voting.py.

Rebuild of test_ScanNet_voting.py: for each of vote_num fixed rotations the
scene is voxelized in 'multiple' mode, so that every raw point lies in at
least one covering set; each covering set is chunked to MAX_POINTS_NUM,
predicted, and its softmax probabilities are scatter-added into the
full-resolution cloud through the crop indices; the votes average across
rotations. Writes <scene>_probs.npy, .ply and .txt per scene.

One program per chunk: under cfg.device_pyramid the pyramid build, under
cfg.post_knn the kNN, then the forward and the softmax. On the card it is
captured as one CUDA graph per (caps, batch signature) and replayed, as
pcf_tpu jit-compiles one program per caps key. Chunk i+1 is replayed before
chunk i's probabilities are read back, so that the host's accumulation
overlaps the card; each replay's outputs are copied before the next
overwrites them. Covering sets are built ahead by a thread pool; every CUDA
call stays on the calling thread.

Usage:
  python -m pcf_torch.eval.voting --config pcf_torch/configs/<name>.json
      --pretrain_path <exp>/model [--vote_num 8] [--init_deg 0.0]
      [--set KEY=VALUE ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pcf_torch.utils.logger import get_logger


def _chunk_item(item: dict, max_points: int):
    """Split one covering-set item into chunks of at most max_points points,
    in point order (the reference's collect_fn_test)."""
    n = item["point_list"][0].shape[0]
    if n <= max_points:
        return [item]
    chunks = []
    for s in range(0, n, max_points):
        e = min(s + max_points, n)
        sub = dict(item)
        sub["crop_idx"] = item["crop_idx"][s:e]
        sub["_slice"] = (s, e)
        chunks.append(sub)
    return chunks


def _cascade_caps(batch, grid_sizes) -> tuple:
    """Per-level caps for the device pyramid of `batch`, from a host count of
    its voxel cascade: each level's barycenters voxelized at the next grid
    from the batch-global origin, with the scene in the key, as
    ops/subsample.grid_subsample_fixed voxelizes them. Level 0 keeps its
    rows; each level above gets its count plus 128 (a barycenter rounded
    otherwise on the device may land in a neighbouring voxel), rounded up to
    512, which bounds the caps signatures."""
    pts = batch.points[0].cpu().numpy()
    mask = batch.masks[0].cpu().numpy()
    cur, bid = pts[mask], batch.bids[0].cpu().numpy()[mask].astype(np.int64)
    caps = [pts.shape[0]]
    for g in grid_sizes[1:]:
        g = float(g)
        origin = np.floor(cur.min(0) / g) * g
        cell = np.floor((cur - origin) / g).astype(np.int64)
        dims = cell.max(0) + 1
        key = ((bid * dims[0] + cell[:, 0]) * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
        bary = np.zeros((uniq.shape[0], 3))
        np.add.at(bary, inv, cur.astype(np.float64))
        cur = (bary / counts[:, None]).astype(np.float32)
        bid = uniq // (dims[0] * dims[1] * dims[2])
        caps.append(int(-(-(uniq.shape[0] + 128) // 512) * 512))
    return tuple(caps)


def evaluate_voting(cfg, pretrain_path: str | None = None, split: str = "validation",
                    vote_num: int = 8, init_deg: float = 0.0, state=None,
                    max_scenes: int | None = None, write_outputs: bool = True, device=None):
    """The voting mIoU of cfg's model over `split`.

    The model is `state`'s (a TrainState or a model; evaluated where it
    lies), or else one built from cfg on `device` ("cuda" by default,
    raising without a card) with the latest checkpoint under pretrain_path.
    cfg.vote_batch covering sets are packed per forward (default 1).
    Outputs go to cfg.eval_path."""
    from pcf_torch.config import Config
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.post_knn import prepare_flagged, static_args
    from pcf_torch.data.scannet import ScanNetDataset
    from pcf_torch.entry import build, resolve_device
    from pcf_torch.eval.io import write_labels_txt, write_ply_color
    from pcf_torch.ops.kernels.derived import model_tensors, stamp
    from pcf_torch.parallel.graphs import StepGraphs
    from pcf_torch.parallel.mesh import _program_key
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.train.metrics import intersection_and_union
    from pcf_torch.utils.cache import enable_compile_cache

    if state is not None:
        model = getattr(state, "model", state)
        device = next(model.parameters()).device
    else:
        model, device = None, resolve_device(device)
    enable_compile_cache(device)

    eval_dir = cfg.get("eval_path", "./experiments/eval_torch/evaluation_voting")
    os.makedirs(eval_dir, exist_ok=True)
    logger = get_logger(eval_dir)

    if model is None:
        model = build(cfg, device, seed=0)
        if pretrain_path:
            params, stats, ep = CheckpointManager(pretrain_path).restore_eval()
            if params is None:
                raise FileNotFoundError(f"no checkpoint found at {pretrain_path}")
            model.load_state_dict({**params, **stats})
            logger.info(f"restored {pretrain_path} (epoch {ep})")
    model.eval()

    # one dataset per rotation vote (reference: test_ScanNet_voting.py:202-212)
    datasets = [ScanNetDataset(cfg, split=split, rotate_deg=init_deg + v / vote_num,
                               voxelize_mode="multiple", seed=cfg.manual_seed)
                for v in range(vote_num)]
    n_scenes = len(datasets[0]) if max_scenes is None else min(max_scenes, len(datasets[0]))
    # chunks packed per forward; 1, the reference's one covering set per
    # forward, measured fastest for pcf_tpu (a signature per combination)
    vote_batch = int(cfg.get("vote_batch", 1))
    device_prep = cfg.get("post_knn") or cfg.get("device_pyramid")
    # the device pyramid's scene count is the voting group's
    pcfg = Config(cfg)
    pcfg.BATCH_SIZE = max(vote_batch, 1)
    check = cfg.get("check_pyramid_overflow", True)

    def caps_cfg(b):
        """Covering sets keep every point distinct at coarse grids, so the
        trainer's shrink-derived caps would overflow: under device_pyramid
        each batch takes caps from its own host cascade count."""
        if not pcfg.get("device_pyramid") or pcfg.get("device_level_caps"):
            return pcfg
        c = Config(pcfg)
        c.device_level_caps = _cascade_caps(b, pcfg.grid_size)
        return c

    def body(b, ccfg):
        with torch.no_grad():
            flag = None
            if device_prep:
                b, flag = prepare_flagged(b, ccfg)
            return torch.softmax(model.forward_batch(b).float(), -1), flag

    graphs = StepGraphs()
    programs = set()  # the caps keys seen

    def dispatch(b, ccfg):
        """(probs, overflow flag or None) of one chunk, a copy of the
        graph's outputs on the card."""
        if device.type != "cuda":
            return body(b.to(device), ccfg)
        key = static_args(ccfg, b.points[0].shape[0]) if device_prep else ()
        programs.add(key)
        (probs, flag), _ = graphs.run(("vote", key, _program_key(model)), b.signature(),
                                      stamp(model_tensors(model)), lambda s: body(s, ccfg),
                                      b, device, keep=(model,))
        return probs.clone(), None if flag is None else flag.clone()

    def vote_jobs(idx, ds):
        """[(chunk item, crop indices)] of scene idx under ds's rotation, and
        the seconds it took to build them."""
        t = time.perf_counter()
        jobs = []
        for item in ds[idx]:
            for chunk in _chunk_item(item, cfg.MAX_POINTS_NUM):
                if "_slice" in chunk:
                    # an oversized covering set: the chunk's item is rebuilt
                    # from its sliced level-0 points (slicing the pyramid
                    # would keep edges into points outside the chunk);
                    # _build_item follows cfg's mode
                    s, e = chunk.pop("_slice")
                    chunk_item = ds._build_item(
                        item["point_list"][0][s:e], item["surface_normal_list"][0][s:e],
                        item["feature_list"][s:e], item["label_list"][s:e])
                else:
                    chunk_item = {k: v for k, v in chunk.items() if k != "crop_idx"}
                jobs.append((chunk_item, chunk["crop_idx"]))
        return jobs, time.perf_counter() - t

    sums = np.zeros((3, cfg.num_classes))  # intersection, union, target
    t_start = time.perf_counter()
    fwd_s, job_s, n_fwd = 0.0, 0.0, 0

    with ThreadPoolExecutor(max_workers=int(cfg.get("eval_workers", 8))) as pool:
        def submit(idx):
            return [pool.submit(vote_jobs, idx, ds) for ds in datasets]

        pending = submit(0)
        for idx in range(n_scenes):
            raw_n = datasets[0].raw_coord(idx).shape[0]
            accum = np.zeros((raw_n, cfg.num_classes), np.float64)
            counts = np.zeros(raw_n, np.float64)
            futs, pending = pending, (submit(idx + 1) if idx + 1 < n_scenes else [])
            jobs = []
            for f in futs:
                j, s = f.result()
                jobs += j
                job_s += s

            def drain(entry):
                nonlocal fwd_s, n_fwd
                probs, flag, bids, group, t0 = entry
                pr = probs.cpu().numpy()  # waits for the chunk
                if flag is not None:
                    if check:
                        if bool(flag):
                            raise ValueError("device pyramid overflowed a level cap; raise "
                                             "cfg.device_level_caps (or MAX_POINTS_NUM)")
                    elif bool(flag):
                        logger.warning("device pyramid overflowed a level cap (voxels "
                                       "dropped) and cfg.check_pyramid_overflow is off: "
                                       "these votes come from a truncated pyramid")
                fwd_s += time.perf_counter() - t0
                n_fwd += 1
                for j, (_, crop_idx) in enumerate(group):
                    accum[crop_idx] += pr[bids == j]
                    counts[crop_idx] += 1.0

            in_flight = None
            for g0 in range(0, len(jobs), vote_batch):
                group = jobs[g0:g0 + vote_batch]
                batch = pack_scenes([j[0] for j in group], bucket_multiple=cfg.bucket_multiple,
                                    ignore_label=cfg.ignore_label)
                ccfg = caps_cfg(batch) if device_prep else pcfg
                t0 = time.perf_counter()
                probs, flag = dispatch(batch, ccfg)
                # the rows of chunk j of the group are those of bid j
                entry = (probs, flag, batch.bids[0].numpy(), group, t0)
                if in_flight is not None:
                    drain(in_flight)
                in_flight = entry
            if in_flight is not None:
                drain(in_flight)

            if counts.min() <= 0:
                raise RuntimeError("voting left raw points without a vote")
            pred = accum.argmax(-1)
            raw_labels = datasets[0].data[idx][3]
            hists = intersection_and_union(torch.from_numpy(pred),
                                           torch.from_numpy(np.asarray(raw_labels)),
                                           cfg.num_classes, cfg.ignore_label)
            for i, h in enumerate(hists):
                sums[i] += h.numpy()

            name = os.path.basename(str(datasets[0].scene_name(idx)))
            if write_outputs:
                np.save(os.path.join(eval_dir, f"{name}_probs.npy"),
                        (accum / np.maximum(counts[:, None], 1)).astype(np.float32))
                write_ply_color(os.path.join(eval_dir, f"{name}.ply"),
                                datasets[0].raw_coord(idx), pred)
                write_labels_txt(os.path.join(eval_dir, f"{name}.txt"), pred)
            logger.info(f"{idx + 1}/{n_scenes} {name}: {raw_n} raw pts, miou so far "
                        f"{np.mean(sums[0] / np.maximum(sums[1], 1)):.4f}")

    miou = float(np.mean(sums[0] / np.maximum(sums[1], 1)))
    logger.info(f"Voting wall {time.perf_counter() - t_start:.3f}s (device+dispatch "
                f"{fwd_s:.3f}s across {n_fwd} forwards: dispatch->drain spans, overlapping "
                f"under the one-in-flight pipeline; host jobs {job_s:.3f}s in "
                f"{len(datasets)} rotation(s) per scene, on the pool; graphs: "
                f"{len(programs)} caps key(s), {graphs.captures} captured, "
                f"{graphs.replays} replays; "
                f"vote_batch={vote_batch})")
    logger.info(f"Voting mIoU ({vote_num} votes): {miou:.4f}")
    return miou


if __name__ == "__main__":
    from pcf_torch.config import load_config

    p = argparse.ArgumentParser("pcf_torch voting eval")
    p.add_argument("--config", required=True)
    p.add_argument("--pretrain_path", default=None)
    p.add_argument("--split", default="validation")
    p.add_argument("--vote_num", type=int, default=8)
    p.add_argument("--init_deg", type=float, default=0.0)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    a = p.parse_args()
    evaluate_voting(load_config(a.config, a.overrides), a.pretrain_path, a.split,
                    a.vote_num, a.init_deg, device=a.device)
