"""Training: the loops, `main` and the CLI (pcf_tpu/train/trainer.py).

The same config surface and training semantics as pcf_tpu's trainer
(weighted smoothed CE, schedules stepped per iteration, grad clip and
accumulation, IoU metrics, checkpoints with resume and best tracking) on
one device: the train and eval steps of parallel/mesh.py, which on the card
are captured once per bucket signature as CUDA graphs and replayed. A mesh
(cfg.data_parallel > 1, multi_host, spatial_train) is not ported yet and
raises. Metrics stay on the device until a print boundary, as in pcf_tpu:
reading a number back to the host waits for the card, which would idle it
while the host prepares the next batch. cfg.profile_dir traces
cfg.profile_steps steps of epoch cfg.profile_epoch with torch.profiler.

Usage: python -m pcf_torch.train.trainer --config pcf_tpu/configs/pcf_10cm.yaml
       [--set KEY=VALUE ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pcf_torch.parallel.mesh import check_single_device, step_seed
from pcf_torch.train.metrics import AverageMeter, intersection_and_union
from pcf_torch.utils.logger import get_logger
from pcf_torch.utils.memory import graph_pool_bytes, hbm_peak_gib, hbm_summary


def _scores(inter, union, target):
    miou = float(np.mean(inter / np.maximum(union, 1)))
    macc = float(np.mean(inter / np.maximum(target, 1)))
    allacc = float(inter.sum() / max(target.sum(), 1))
    return miou, macc, allacc


def _group_batches(loader, group: int, map_fn=None, pad_tail: bool = False):
    """Yield (batches, n_real): `group` consecutive packed batches (one per
    device) plus how many are real. With pad_tail the final partial group is
    padded by repeating its last batch, so validation covers every scene;
    without it the tail is dropped (training)."""
    buf = []
    for b in loader:
        buf.append(b if map_fn is None else map_fn(b))
        if len(buf) == group:
            yield buf, group
            buf = []
    if buf and pad_tail:
        n_real = len(buf)
        buf.extend(buf[-1:] * (group - n_real))
        yield buf, n_real


def _post_knn_fn(cfg):
    """The on-device kNN after batching (cfg.post_knn, cfg.device_pyramid),
    which is not ported yet: raises for either; None without them."""
    if cfg.get("post_knn") or cfg.get("device_pyramid"):
        raise NotImplementedError(
            "cfg.post_knn and cfg.device_pyramid (the pyramid and kNN built on the "
            "device after packing) are not ported to pcf_torch yet")
    return None


def _log_step_memory(step_fn, logger):
    """Once, after the first step: the pools of the train step's captured
    graphs (the memory reserved across each capture, the counterpart of
    pcf_tpu's static analysis of its compiled step) and the peak allocated
    during the step, its eager run and capture included."""
    graphs = getattr(step_fn, "graphs", None)
    if graphs is None or not graphs.entries:
        return
    pools, peak = graph_pool_bytes(graphs), hbm_peak_gib()
    logger.info(f"train-step memory: {pools['graphs']} captured graph(s), pool "
                f"{pools['pool_bytes'] / 2**30:.2f} GiB ({pools['live_bytes'] / 2**30:.2f} "
                f"GiB live)" + ("" if peak is None else f"; step peak {peak:.2f} GiB"))


def _start_trace():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, loss, profile_dir, epoch, steps, logger):
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"train_epoch{epoch}.trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace of {steps} step(s) of epoch {epoch}: {path}")


def train_one_epoch(step_fn, state, loader, mesh, epoch, cfg, logger, rng_seed):
    """One pass of step_fn over loader; returns (state, mean loss, mIoU,
    mAcc, allAcc). Step `it` of the epoch is seeded with
    step_seed(rng_seed, epoch * 100000 + it), pcf_tpu's fold_in. In epoch
    cfg.profile_epoch (default 0), cfg.profile_dir gets a torch.profiler
    trace of steps 1 to cfg.profile_steps (default 5): the first step, which
    builds and captures, is left out."""
    check_single_device(mesh)
    _post_knn_fn(cfg)
    loss_meter = AverageMeter()
    sums = np.zeros((3, cfg.num_classes))  # intersection, union, target
    pending: list = []  # device-side metrics awaiting host readback

    def flush():
        for m in pending:
            loss_meter.update(float(m["loss"]))
            for i, k in enumerate(("intersection", "union", "target")):
                sums[i] += np.asarray(torch.as_tensor(m[k]).cpu())
        pending.clear()

    profile_dir = cfg.get("profile_dir") if epoch == cfg.get("profile_epoch", 0) else None
    profile_steps = cfg.get("profile_steps", 5)
    prof = None
    t0 = time.time()
    it = 0
    for batch in loader:
        if profile_dir and it == 1:
            prof = _start_trace()
        if it == 0 and torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        state, metrics = step_fn(state, batch, step_seed(rng_seed, epoch * 100000 + it))
        if it == 0:
            _log_step_memory(step_fn, logger)
        pending.append(metrics)
        it += 1
        if prof is not None and it > profile_steps:
            _stop_trace(prof, metrics["loss"], profile_dir, epoch, it - 1, logger)
            prof = None
        if it % cfg.print_freq == 0:
            flush()
            miou = np.mean(sums[0] / np.maximum(sums[1], 1))
            mem = hbm_summary()
            logger.info(f"epoch {epoch} iter {it} loss {loss_meter.val:.4f} "
                        f"(avg {loss_meter.avg:.4f}) mIoU {miou:.4f} "
                        f"{(time.time() - t0) / it:.2f}s/it" + (f" {mem}" if mem else ""))
    if prof is not None:
        _stop_trace(prof, metrics["loss"], profile_dir, epoch, it - 1, logger)
    flush()
    return (state, loss_meter.avg) + _scores(*sums)


def validate(eval_step, state, loader, mesh, cfg, logger):
    """mIoU, mAcc and allAcc of eval_step's predictions over loader."""
    check_single_device(mesh)
    _post_knn_fn(cfg)
    pending = []  # device-side histograms; read back at the end
    for batch in loader:
        logits = eval_step(state, batch)
        labels, mask = batch.labels.to(logits.device), batch.masks[0].to(logits.device)
        pending.append(intersection_and_union(logits.argmax(-1), labels,
                                              cfg.num_classes, cfg.ignore_label,
                                              mask=mask))
    sums = np.zeros((3, cfg.num_classes))
    for hists in pending:
        for i, h in enumerate(hists):
            sums[i] += h.cpu().numpy()
    miou, macc, allacc = _scores(*sums)
    logger.info(f"Val result: mIoU/mAcc/allAcc {miou:.4f}/{macc:.4f}/{allacc:.4f}")
    for c, v in enumerate(sums[0] / np.maximum(sums[1], 1)):
        logger.info(f"Class_{c} Result: iou {v:.4f}")
    return miou, macc, allacc


def _check_ported(cfg):
    if (cfg.get("data_parallel") or 1) > 1 or cfg.get("multi_host") \
            or cfg.get("spatial_train"):
        raise NotImplementedError(
            "data parallelism (cfg.data_parallel > 1, multi_host, spatial_train) is "
            "not ported to pcf_torch yet; the trainer runs on one device")
    _post_knn_fn(cfg)


def main(cfg, device=None):
    """Train cfg's model on its ScanNet-layout data (pcf_tpu's main): the
    loaders, the model from cfg with weights drawn from cfg.manual_seed, its
    optimizer, a resume from <experiment_dir>/model when a checkpoint is
    there, then per epoch a training pass, validation every cfg.eval_freq
    epochs and a checkpoint every cfg.save_freq. The run goes to `device`,
    "cuda" by default (raising without a card). Returns the final TrainState."""
    from pcf_torch.data.scannet import getdataLoaders
    from pcf_torch.entry import build, resolve_device
    from pcf_torch.parallel.mesh import make_eval_step, make_train_step
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.train.state import create_train_state, make_optimizer
    from pcf_torch.utils.cache import enable_compile_cache
    from pcf_torch.utils.experiment import MetricsWriter, snapshot_code

    _check_ported(cfg)
    device = resolve_device(device)
    built = enable_compile_cache(device)

    exp_dir = cfg.get("experiment_dir", "./experiment")
    os.makedirs(exp_dir, exist_ok=True)
    logger = get_logger(exp_dir)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + f"; host pyramid: {'native' if built['native'] else 'numpy/scipy'}; "
                f"kernels: {built['kernels'] or 'none (plain versions on the CPU)'}")
    snapshot_code(exp_dir, cfg.get("config"))
    writer = MetricsWriter(exp_dir, cfg.get("use_tensorboard", False))
    try:
        train_loader, val_loader, _, _ = getdataLoaders(cfg)
        logger.info(f"level caps {cfg.get('level_caps')}, window sizes "
                    f"{cfg.get('window_sizes')}")

        model = build(cfg, device, seed=cfg.manual_seed)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"model parameters: {n_params / 1e6:.2f}M")

        iter_per_epoch = max(len(train_loader), 1)
        tx, schedule = make_optimizer(cfg, iter_per_epoch)
        state = create_train_state(model, tx)

        ckpt = CheckpointManager(os.path.join(exp_dir, "model"))
        try:
            state, init_epoch = ckpt.restore(state)
        except ValueError as e:
            # the optimizer's state does not fit (a checkpoint of another
            # optimizer): warm-start the weights and BN statistics with a
            # fresh optimizer rather than refuse to train
            params, stats, init_epoch = ckpt.restore_eval()
            model.load_state_dict({**params, **stats})
            logger.warning(
                f"full-state restore failed ({type(e).__name__}: {e}); warm-started "
                f"params/batch_stats from epoch {init_epoch} with a fresh optimizer state")
        if init_epoch:
            logger.info(f"resumed from epoch {init_epoch}")

        class_weights = cfg.get("weights") if cfg.USE_WEIGHT else None
        step_fn = make_train_step(cfg, class_weights=class_weights)
        eval_step = make_eval_step(cfg)

        best_miou = 0.0
        for epoch in range(init_epoch, cfg.total_epoches):
            train_loader.set_epoch(epoch)
            logger.info(f"lr: {float(schedule(state.tx.count)):.6f}")
            state, loss, miou, macc, allacc = train_one_epoch(
                step_fn, state, train_loader, None, epoch, cfg, logger, cfg.manual_seed)
            logger.info(f"Train epoch {epoch}: loss {loss:.4f} mIoU/mAcc/allAcc "
                        f"{miou:.4f}/{macc:.4f}/{allacc:.4f}")
            writer.write(epoch, train_loss=loss, train_miou=miou, train_macc=macc,
                         train_allacc=allacc, lr=float(schedule(state.tx.count)))

            epoch_log = epoch + 1
            metrics = {}
            if epoch_log % cfg.eval_freq == 0:
                vmiou, vmacc, vallacc = validate(eval_step, state, val_loader, None, cfg,
                                                 logger)
                metrics["miou"] = vmiou
                best_miou = max(best_miou, vmiou)
                logger.info(f"best val mIoU {best_miou:.4f}")
                writer.write(epoch, val_miou=vmiou, val_macc=vmacc, val_allacc=vallacc)
            if epoch_log % cfg.save_freq == 0:
                ckpt.save(epoch_log, state, metrics)
                logger.info(f"saved checkpoint at epoch {epoch_log}")
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    from pcf_torch.config import load_config

    parser = argparse.ArgumentParser("pcf_torch ScanNet training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE", help="config override (repeatable)")
    parser.add_argument("--device", default=None,
                        help="the device to train on (default: cuda)")
    args = parser.parse_args()
    main(load_config(args.config, args.overrides), device=args.device)
