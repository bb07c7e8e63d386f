"""The training and validation loops (pcf_tpu/train/trainer.py:91-201).

Both take any iterable of packed batches. Metrics stay on the device until
a print boundary, as in pcf_tpu: reading a number back to the host waits
for the card, which would idle it while the host prepares the next batch.
The CLI and `main` need the ScanNet loaders, which are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pcf_torch.parallel.mesh import check_single_device, step_seed
from pcf_torch.train.metrics import AverageMeter, intersection_and_union


def _memory_note() -> str:
    if not torch.cuda.is_available():
        return ""
    return (f" mem {torch.cuda.memory_allocated() / 2**30:.2f} GiB"
            f" (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")


def _scores(inter, union, target):
    miou = float(np.mean(inter / np.maximum(union, 1)))
    macc = float(np.mean(inter / np.maximum(target, 1)))
    allacc = float(inter.sum() / max(target.sum(), 1))
    return miou, macc, allacc


def train_one_epoch(step_fn, state, loader, mesh, epoch, cfg, logger, rng_seed):
    """One pass of step_fn over loader; returns (state, mean loss, mIoU,
    mAcc, allAcc). Step `it` of the epoch is seeded with
    step_seed(rng_seed, epoch * 100000 + it), pcf_tpu's fold_in."""
    check_single_device(mesh)
    if cfg.get("profile_dir"):
        raise NotImplementedError("cfg.profile_dir (a profiler trace of the first "
                                  "epoch) is not ported to pcf_torch yet")
    loss_meter = AverageMeter()
    sums = np.zeros((3, cfg.num_classes))  # intersection, union, target
    pending: list = []  # device-side metrics awaiting host readback

    def flush():
        for m in pending:
            loss_meter.update(float(m["loss"]))
            for i, k in enumerate(("intersection", "union", "target")):
                sums[i] += np.asarray(torch.as_tensor(m[k]).cpu())
        pending.clear()

    t0 = time.time()
    it = 0
    for batch in loader:
        state, metrics = step_fn(state, batch, step_seed(rng_seed, epoch * 100000 + it))
        pending.append(metrics)
        it += 1
        if it % cfg.print_freq == 0:
            flush()
            miou = np.mean(sums[0] / np.maximum(sums[1], 1))
            logger.info(f"epoch {epoch} iter {it} loss {loss_meter.val:.4f} "
                        f"(avg {loss_meter.avg:.4f}) mIoU {miou:.4f} "
                        f"{(time.time() - t0) / it:.2f}s/it" + _memory_note())
    flush()
    return (state, loss_meter.avg) + _scores(*sums)


def validate(eval_step, state, loader, mesh, cfg, logger):
    """mIoU, mAcc and allAcc of eval_step's predictions over loader."""
    check_single_device(mesh)
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
