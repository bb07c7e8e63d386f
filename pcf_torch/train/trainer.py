"""Training: the loops, `main` and the CLI (pcf_tpu/train/trainer.py).

The same config surface and training semantics as pcf_tpu's trainer
(weighted smoothed CE, schedules stepped per iteration, grad clip and
accumulation, IoU metrics, checkpoints with resume and best tracking): the
train and eval steps of parallel/mesh.py, which on the card are captured
once per bucket signature as CUDA graphs and replayed. Data-parallel
training runs one process per device, started by torchrun (pcf_tpu's
jax.distributed.initialize and its device mesh, :29-41, :206-211): with
cfg.multi_host, cfg.data_parallel > 1 or a WORLD_SIZE above 1 in the
environment, main joins the process group that torchrun's environment
names (NCCL on cuda:LOCAL_RANK, gloo on the CPU), and with more than one
rank trains on a mesh (build_mesh_and_cfg: SyncBN, pinned level caps,
window overflow dropped), each rank on its own shard of the scenes; only
rank 0 logs, snapshots the code and writes checkpoints. With
cfg.spatial_train in a process group (pcf_tpu's :290-300) every rank loads
the same batches, the whole loader, and the steps shard each batch's points
over the ranks (parallel/spatial.py); the loop then runs as without a mesh,
the collectives inside the steps. In one process spatial_train changes
nothing, as in pcf_tpu, whose mesh is None on one device. Under
cfg.post_knn or cfg.device_pyramid every batch is completed
on the device (data/post_knn.make_prepare, one CUDA graph per batch
signature) before its step. Metrics stay on the device until a print
boundary, as in pcf_tpu: reading a number back to the host waits for the
card, which would idle it while the host prepares the next batch.
cfg.profile_dir traces cfg.profile_steps steps of epoch cfg.profile_epoch
with torch.profiler.

Usage: python -m pcf_torch.train.trainer --config pcf_torch/configs/pcf_10cm.json
       [--set KEY=VALUE ...] [--device cpu]
       torchrun --nproc_per_node=N -m pcf_torch.train.trainer --config ...
           [--set spatial_train=true]
The shipped configurations are pcf_torch/configs/*.json (read without
PyYAML); a --set value is parsed as YAML would parse it (config.parse_value),
e.g. --set total_epoches=1 --set 'level_caps=[49152, 24576, 8192, 2048, 512]'.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from pcf_torch.parallel.mesh import AXIS, all_have, make_mesh, step_seed
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


def init_distributed(device_type: str) -> tuple[int, int, int]:
    """Join the process group that torchrun's environment names (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on
    cuda:LOCAL_RANK for a CUDA run, gloo on the CPU; pcf_tpu's
    jax.distributed.initialize. One eager all_reduce follows, so that a
    failed init raises here and the communicator is in use before any step
    is captured. Returns (rank, world size, local rank)."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing and not dist.is_initialized():
        raise RuntimeError(f"data-parallel training needs torchrun's environment; "
                           f"{', '.join(missing)} not set")
    local = int(env.get("LOCAL_RANK", 0))
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    probe = torch.zeros(1, device=torch.device("cuda", local) if device_type == "cuda"
                        else "cpu")
    dist.all_reduce(probe)
    return dist.get_rank(), dist.get_world_size(), local


def build_mesh_and_cfg(cfg, device=None):
    """The data mesh (pcf_tpu's build_mesh_and_cfg): over cfg.data_parallel
    ranks (default: the process group's size; 1 without one), or None for
    one. Under a mesh the BatchNorm statistics are summed over the ranks
    (cfg.bn_axis_name, cfg.sync_bn)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = cfg.get("data_parallel") or world
    if n != world:
        raise ValueError(f"cfg.data_parallel = {n}, but the process group has {world} "
                         f"rank(s): start one process per device with torchrun "
                         f"--nproc_per_node={n}")
    mesh = make_mesh(n, device) if n > 1 else None
    if mesh is not None:
        cfg.bn_axis_name = AXIS
        cfg.sync_bn = True
    return mesh


def _post_knn_fn(cfg):
    """The pyramid and kNN built on the device after batching (cfg.post_knn,
    cfg.device_pyramid): data/post_knn.make_prepare's prep(batch, device),
    captured once per batch signature on the card; None without them."""
    if not (cfg.get("post_knn") or cfg.get("device_pyramid")):
        return None
    from pcf_torch.data import post_knn

    return post_knn.make_prepare(cfg)


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


def train_one_epoch(step_fn, state, loader, mesh, epoch, cfg, logger, rng_seed,
                    prepare=None):
    """One pass of step_fn over loader; returns (state, mean loss, mIoU,
    mAcc, allAcc). Under cfg.post_knn or cfg.device_pyramid each batch goes
    to the model's device and through `prepare` (_post_knn_fn's, made anew
    when None) before its step. Step `it` of the epoch is seeded with
    step_seed(rng_seed, epoch * 100000 + it), pcf_tpu's fold_in. In epoch
    cfg.profile_epoch (default 0), cfg.profile_dir gets a torch.profiler
    trace of steps 1 to cfg.profile_steps (default 5): the first step, which
    builds and captures, is left out. Under a mesh the ranks step together:
    the epoch ends at the first step that some rank has no batch for (the
    tail dropped, as pcf_tpu's grouping drops it), and the metrics, which
    the step reduced over the ranks, are the same on every rank."""
    prepare = prepare or _post_knn_fn(cfg)
    if prepare is not None:
        device = next(state.model.parameters()).device
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
    batches = iter(loader)
    while True:
        batch = next(batches, None)
        if not all_have(mesh, batch is not None):
            break
        if profile_dir and it == 1:
            prof = _start_trace()
        if it == 0 and torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        if prepare is not None:
            batch = prepare(batch, device)
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


def validate(eval_step, state, loader, mesh, cfg, logger, prepare=None):
    """mIoU, mAcc and allAcc of eval_step's predictions over loader, each
    batch through `prepare` as in train_one_epoch. Under a mesh each rank
    evaluates its own shard, with no collective per batch (the eval step
    has none), and the histograms are summed over the ranks once at the
    end, so a rank with fewer batches waits on no collective that the
    others do not call."""
    prepare = prepare or _post_knn_fn(cfg)
    if prepare is not None:
        device = next(getattr(state, "model", state).parameters()).device
    pending = []  # device-side histograms; read back at the end
    for batch in loader:
        if prepare is not None:
            batch = prepare(batch, device)
        logits = eval_step(state, batch)
        labels, mask = batch.labels.to(logits.device), batch.masks[0].to(logits.device)
        pending.append(intersection_and_union(logits.argmax(-1), labels,
                                              cfg.num_classes, cfg.ignore_label,
                                              mask=mask))
    sums = np.zeros((3, cfg.num_classes))
    for hists in pending:
        for i, h in enumerate(hists):
            sums[i] += h.cpu().numpy()
    if mesh is not None:
        total = torch.from_numpy(sums).to(mesh.device)
        dist.all_reduce(total, group=mesh.group)
        sums = total.cpu().numpy()
    miou, macc, allacc = _scores(*sums)
    logger.info(f"Val result: mIoU/mAcc/allAcc {miou:.4f}/{macc:.4f}/{allacc:.4f}")
    for c, v in enumerate(sums[0] / np.maximum(sums[1], 1)):
        logger.info(f"Class_{c} Result: iou {v:.4f}")
    return miou, macc, allacc


def _distributed(cfg) -> bool:
    """Whether main joins a process group: multi_host, data_parallel > 1, or
    a torchrun world of more than one rank."""
    return bool(cfg.get("multi_host")) or (cfg.get("data_parallel") or 1) > 1 \
        or int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(cfg, device=None):
    """Train cfg's model on its ScanNet-layout data (pcf_tpu's main): the
    loaders, the model from cfg with weights drawn from cfg.manual_seed, its
    optimizer, a resume from <experiment_dir>/model when a checkpoint is
    there, then per epoch a training pass, validation every cfg.eval_freq
    epochs and a checkpoint every cfg.save_freq. The run goes to `device`,
    "cuda" by default (raising without a card; cuda:LOCAL_RANK in a process
    group). Returns the final TrainState."""
    from pcf_torch.data.scannet import getdataLoaders
    from pcf_torch.entry import build, resolve_device
    from pcf_torch.parallel.mesh import make_eval_step, make_train_step
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.train.state import create_train_state, make_optimizer
    from pcf_torch.utils.cache import enable_compile_cache
    from pcf_torch.utils.experiment import MetricsWriter, snapshot_code

    if cfg.get("spatial_train"):
        from pcf_torch.parallel.spatial import check_family

        check_family(cfg)
    device = resolve_device(device)
    rank, world = 0, 1
    if _distributed(cfg):
        rank, world, local = init_distributed(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", local)
    # spatial_train: one batch per step, its points sharded over every rank
    # of the group (even one), in place of one batch per rank
    spatial = bool(cfg.get("spatial_train")) and dist.is_available() and dist.is_initialized()
    mesh = make_mesh(None, device) if spatial else build_mesh_and_cfg(cfg, device)
    if mesh is not None:
        # pinned level caps: every rank's batches have the same shapes, and
        # the step is captured once; a window overflow drops the scene (a
        # fall-back to plain edges would change the batch's structure)
        cfg.setdefault("pin_level_caps", True)
        if cfg.get("window_gather"):
            cfg.setdefault("window_overflow", "drop")
    built = enable_compile_cache(device)

    exp_dir = cfg.get("experiment_dir", "./experiment")
    os.makedirs(exp_dir, exist_ok=True)
    logger = get_logger(exp_dir, distributed_rank=rank)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + f"; rank {rank} of {world}"
                + f"; host pyramid: {'native' if built['native'] else 'numpy/scipy'}; "
                f"kernels: {built['kernels'] or 'none (plain versions on the CPU)'}")
    if rank == 0:
        snapshot_code(exp_dir, cfg.get("config"))
    writer = MetricsWriter(exp_dir, cfg.get("use_tensorboard", False)) if rank == 0 else None
    try:
        # under spatial_train every rank reads the whole loader, the same
        # batches in the same order (the same seed)
        train_loader, val_loader, _, _ = (getdataLoaders(cfg) if spatial else
                                          getdataLoaders(cfg, rank, world))
        logger.info(f"level caps {cfg.get('level_caps')}, window sizes "
                    f"{cfg.get('window_sizes')}")

        model = build(cfg, device, seed=cfg.manual_seed)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"model parameters: {n_params / 1e6:.2f}M")

        # the steps of an epoch. Data parallel: this rank's shard,
        # len(dataset) // world scenes in batches of BATCH_SIZE, pcf_tpu's
        # len(train_loader) // mesh.size for the same data and device count.
        # spatial_train: every batch, one a step (pcf_tpu divides by the mesh
        # size there too, which makes its schedule's epochs that many times
        # shorter than its loop's)
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
        if spatial:
            from pcf_torch.parallel.spatial import (make_spatial_eval_step,
                                                    make_spatial_train_step)

            step_fn = make_spatial_train_step(cfg, mesh, class_weights=class_weights)
            eval_step = make_spatial_eval_step(cfg, mesh)
            mesh = None  # the loops see one process: the collectives are the steps'
        else:
            step_fn = make_train_step(cfg, mesh, class_weights=class_weights)
            eval_step = make_eval_step(cfg, mesh)
        prepare = _post_knn_fn(cfg)  # one for the run: its graphs outlive epochs

        best_miou = 0.0
        for epoch in range(init_epoch, cfg.total_epoches):
            train_loader.set_epoch(epoch)
            logger.info(f"lr: {float(schedule(state.tx.count)):.6f}")
            state, loss, miou, macc, allacc = train_one_epoch(
                step_fn, state, train_loader, mesh, epoch, cfg, logger, cfg.manual_seed,
                prepare=prepare)
            logger.info(f"Train epoch {epoch}: loss {loss:.4f} mIoU/mAcc/allAcc "
                        f"{miou:.4f}/{macc:.4f}/{allacc:.4f}")
            if writer is not None:
                writer.write(epoch, train_loss=loss, train_miou=miou, train_macc=macc,
                             train_allacc=allacc, lr=float(schedule(state.tx.count)))

            epoch_log = epoch + 1
            metrics = {}
            if epoch_log % cfg.eval_freq == 0:
                vmiou, vmacc, vallacc = validate(eval_step, state, val_loader, mesh, cfg,
                                                 logger, prepare=prepare)
                metrics["miou"] = vmiou
                best_miou = max(best_miou, vmiou)
                logger.info(f"best val mIoU {best_miou:.4f}")
                if writer is not None:
                    writer.write(epoch, val_miou=vmiou, val_macc=vmacc,
                                 val_allacc=vallacc)
            if epoch_log % cfg.save_freq == 0 and rank == 0:
                ckpt.save(epoch_log, state, metrics)
                logger.info(f"saved checkpoint at epoch {epoch_log}")
    finally:
        if writer is not None:
            writer.close()
    return state


def parse_args(argv=None):
    """(cfg, device) from the command line (sys.argv[1:] when argv is None):
    --config (a .json config loads with json alone), --set KEY=VALUE
    (repeatable), --device."""
    from pcf_torch.config import load_config

    parser = argparse.ArgumentParser("pcf_torch ScanNet training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE", help="config override (repeatable)")
    parser.add_argument("--device", default=None,
                        help="the device to train on (default: cuda)")
    args = parser.parse_args(argv)
    return load_config(args.config, args.overrides), args.device


def cli(argv=None):
    """`python -m pcf_torch.train.trainer` with these arguments: main on the
    parsed configuration, the process group left after it. Returns main's
    final TrainState."""
    cfg, device = parse_args(argv)
    try:
        return main(cfg, device=device)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
