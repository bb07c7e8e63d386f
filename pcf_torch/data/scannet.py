"""ScanNet dataset + packed data loaders, the port of pcf_tpu/data/scannet.py.

Replaces the reference's torch Dataset/DataLoader stack
(scannet_data_loader_color_DDP.py) with a plain-Python pipeline feeding the
static-shape packed batches of pcf_torch.core.batching:

  * scenes are .pth tuples (coord, color[+normal], label, name) as written by
    the reference's data_preparation/prepare_data.py, or equivalent .npz
    archives (data/prepare.py);
  * per-scene: z-shift, augmentations (rotation, flips, scale, jitter,
    RandomDropColor, crop, Mix3D scene mixing), finest-grid voxelization,
    MAX_POINTS_NUM ball-crop, index shuffle, pyramid + kNN build
    (reference flow: scannet_data_loader_color_DDP.py:85-278); under
    cfg.post_knn the pyramid without edges, under cfg.device_pyramid level 0
    alone, the rest built on the device after packing (data/post_knn.py);
  * batches of BATCH_SIZE scenes are packed + padded to bucketed capacities;
  * data parallelism shards scene indices per process (rank), replacing
    DistributedSampler (:296-297).

Every draw comes from a Generator keyed on (seed, epoch, scene index), so the
same files, seed and epoch give batches bit-identical to pcf_tpu's. A
background thread packs batches ahead of the consumer, and NUM_WORKERS
threads build scenes (cKDTree and the native kNN release the GIL). The
batches are PackedPyramids of CPU tensors: the steps move them to the card,
and nothing here touches CUDA, so every CUDA call stays on the consumer's
thread.
"""

from __future__ import annotations

import glob
import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from pcf_torch.core.batching import PackedPyramid, compute_level_caps, pack_scenes
from pcf_torch.data import transforms as T
from pcf_torch.data.pyramid import scene_to_item, subsample
from pcf_torch.ops.voxelize import voxelize
from pcf_torch.ops.window import WindowOverflow, max_window_uniques


def load_scene_file(path: str):
    """Load one preprocessed scene: returns (coord, color, norm, label, name).

    Accepts the reference's .pth layout (coords, feats[color|color+normal],
    labels, scene_name: data_preparation/prepare_data.py) and .npz with the
    same keys.
    """
    if path.endswith(".npz"):
        z = np.load(path)
        coord = z["coords"].astype(np.float32)
        feats = z["feats"].astype(np.float32)
        label = z["labels"].astype(np.int64) if "labels" in z else None
        name = str(z["name"]) if "name" in z else path
    else:
        import torch

        data = torch.load(path, weights_only=False, map_location="cpu")
        coord, feats, label = data[0], data[1], data[2] if len(data) > 2 else None
        name = data[3] if len(data) > 3 else path
        coord = np.asarray(coord, dtype=np.float32)
        feats = np.asarray(feats, dtype=np.float32)
        label = None if label is None else np.asarray(label)
    if feats.shape[1] >= 6:
        color, norm = feats[:, :3], feats[:, 3:6]
    else:
        color = feats
        norm = np.zeros_like(coord)
    if label is None:
        label = np.full(coord.shape[0], -100, np.int64)
    return coord, color, norm, label.reshape(-1).astype(np.int64), name


def compute_weight(labels_list: Sequence[np.ndarray], num_class: int = 20):
    """Sqrt-inverse-frequency class weights (reference: datasetCommon.py:70-90)."""
    counts = np.zeros(num_class, np.float64)
    for labels in labels_list:
        valid = labels[labels >= 0]
        counts += np.bincount(valid, minlength=num_class)[:num_class]
    ratio = counts / counts.sum()
    return list(1.0 / np.power(np.maximum(ratio, 1e-12), 0.5))


class _RngProxy:
    """Forwards Generator method calls to the owner's thread-local rng, so
    transform objects constructed once work safely from worker threads."""

    def __init__(self, owner):
        self._owner = owner

    def __getattr__(self, name):
        return getattr(self._owner.rng, name)


class ScanNetDataset:
    """In-memory ScanNet scene dataset with reference-parity augmentation."""

    def __init__(self, cfg, split: str = "training", rotate_deg: float = 0.0,
                 voxelize_mode: str = "random", seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.rotate_deg = rotate_deg
        self.voxelize_mode = voxelize_mode
        # thread-local RNG streams: numpy Generators are not thread-safe, and
        # PackedLoader(num_workers>1) fetches scenes from a thread pool
        self._seed = seed
        self._rng_local = threading.local()
        self.epoch = 0  # advanced by PackedLoader.set_epoch

        train_aug = split in ("training", "trainval")
        self.rotate_aug = cfg.rotate_aug and train_aug
        self.flip_aug = cfg.flip_aug and train_aug
        self.scale_aug = cfg.scale_aug and train_aug
        self.transform_aug = cfg.transform_aug and train_aug
        self.color_aug = cfg.color_aug and train_aug
        self.crop = cfg.crop and train_aug
        self.shuffle_index = cfg.shuffle_index and train_aug
        self.mix3D = cfg.mix3D and train_aug
        self.trans_std = [0.02, 0.02, 0.02]
        # transforms capture this proxy once; every method call forwards to
        # the calling thread's own Generator
        rng_proxy = _RngProxy(self)
        self.color_transform = T.Compose([T.RandomDropColor(rng=rng_proxy)])
        self.noisy_points = None
        if cfg.get("noisy_points"):
            self.noisy_points = T.NoisyPoints(
                cfg.noise_level, cfg.noise_pct, cfg.ignore_label, rng=rng_proxy)

        if split == "training":
            files = sorted(glob.glob(cfg.train_data_path))
        elif split == "validation":
            files = sorted(glob.glob(cfg.val_data_path))
        elif split == "trainval":
            files = sorted(glob.glob(cfg.train_data_path)) + sorted(
                glob.glob(cfg.val_data_path))
        else:
            files = sorted(glob.glob(cfg.test_data_path))
        if not files:
            # an empty glob must fail loudly, not let every later loop run
            # zero times and report an mIoU of 0
            raise FileNotFoundError(
                f"no {split} scenes found (train_data_path="
                f"{cfg.get('train_data_path')!r}, val_data_path="
                f"{cfg.get('val_data_path')!r}): generate data first, "
                "e.g. tools/make_synth_dataset.py")
        self.data = [load_scene_file(f) for f in files]
        print(f"{split} examples: {len(self.data)}")

        if cfg.USE_WEIGHT and split in ("training", "trainval"):
            cfg.weights = compute_weight([d[3] for d in self.data],
                                         cfg.get("num_classes", 20))

    @property
    def rng(self) -> np.random.Generator:
        tl = self._rng_local
        if not hasattr(tl, "rng"):  # direct use outside __getitem__
            tl.rng = np.random.default_rng(self._seed)
        return tl.rng

    def __len__(self):
        return len(self.data)

    def scene_name(self, idx):
        return self.data[idx][4]

    def raw_coord(self, idx):
        return self.data[idx][0]

    def _augment(self, coord, color, norm, label):
        """Reference augmentation chain (scannet_data_loader_color_DDP.py:85-159)."""
        rng = self.rng
        if self.rotate_aug:
            theta = np.deg2rad(rng.random() * 360) - np.pi
            c, s = np.cos(theta), np.sin(theta)
            j = np.array([[c, s], [-s, c]], np.float64)
            coord[:, :2] = coord[:, :2] @ j
            norm[:, :2] = norm[:, :2] @ j
        if self.flip_aug:
            flip_type = rng.integers(0, 4)
            if flip_type == 1:
                coord[:, 0] = -coord[:, 0]
                norm[:, 0] = -norm[:, 0]
            elif flip_type == 2:
                coord[:, 1] = -coord[:, 1]
                norm[:, 1] = -norm[:, 1]
            elif flip_type == 3:
                coord[:, :2] = -coord[:, :2]
                norm[:, :2] = -norm[:, :2]
        if self.scale_aug:
            scale = rng.random() * 0.4 + 0.8
            coord[:, 0] *= scale
            coord[:, 1] *= scale
        if self.transform_aug:
            noise = rng.normal(size=coord.shape) * np.asarray(self.trans_std)
            coord[:, :3] += noise
        if self.color_aug:
            coord, color, label, norm = self.color_transform(coord, color, label, norm)
        if self.crop:
            centered = coord - coord.mean(0)
            keep = centered[:, 0] >= 0.0 if rng.random() < 0.5 else centered[:, 0] < 0.0
            coord, color, norm, label = coord[~keep], color[~keep], norm[~keep], label[~keep]
        return coord, color, norm, label

    def __getitem__(self, idx):
        # a per-(seed, epoch, index) stream, installed thread-locally: every
        # draw of this fetch (augment, voxelize, the kNN fallback) is the same
        # whichever worker thread runs it
        self._rng_local.rng = np.random.default_rng((self._seed, self.epoch, int(idx)))
        coord, color, norm, label, _ = self.data[idx]
        coord = coord.copy()
        color = color.copy()
        norm = norm.copy()
        label = label.copy()

        coord[:, 2] -= coord[:, 2].min()

        if self.rotate_deg != 0.0:  # voting-eval fixed rotation (:177-182)
            theta = np.deg2rad(self.rotate_deg * 360) - np.pi
            c, s = np.cos(theta), np.sin(theta)
            j = np.array([[c, s], [-s, c]], np.float64)
            coord[:, :2] = coord[:, :2] @ j
            norm[:, :2] = norm[:, :2] @ j

        coord, color, norm, label = self._augment(coord, color, norm, label)
        if self.noisy_points is not None:
            coord, color, label, norm = self.noisy_points(coord, color, label, norm)

        if self.mix3D and self.rng.random() < 0.8:  # Mix3D (3DV 2021), :192-203
            coord2, color2, norm2, label2, _ = self.data[self.rng.integers(len(self.data))]
            coord2 = coord2.copy()
            coord2[:, 2] -= coord2[:, 2].min()
            coord2, color2, norm2, label2 = self._augment(
                coord2, color2.copy(), norm2.copy(), label2.copy())
            coord = np.concatenate([coord, coord2])
            color = np.concatenate([color, color2])
            norm = np.concatenate([norm, norm2])
            label = np.concatenate([label, label2])

        coord -= coord.min(0)

        cfg = self.cfg
        if self.voxelize_mode == "multiple":
            # eval covering sets: every raw point predicted at least once (:215-244)
            all_data = []
            for crop_idx in voxelize(coord, cfg.grid_size[0], mode="multiple"):
                item = self._build_item(coord[crop_idx], norm[crop_idx],
                                        color[crop_idx], label[crop_idx])
                item["crop_idx"] = crop_idx
                all_data.append(item)
            return all_data

        uniq_idx = voxelize(coord, cfg.grid_size[0], mode=self.voxelize_mode, rng=self.rng)
        coord, color, norm, label = (coord[uniq_idx], color[uniq_idx],
                                     norm[uniq_idx], label[uniq_idx])

        # MAX_POINTS_NUM ball-crop (:247-250)
        if (self.split in ("training", "trainval")
                and label.shape[0] > cfg.MAX_POINTS_NUM):
            init_idx = self.rng.integers(label.shape[0])
            crop_idx = np.argsort(
                np.sum(np.square(coord - coord[init_idx]), 1))[: cfg.MAX_POINTS_NUM]
            coord, color, norm, label = (coord[crop_idx], color[crop_idx],
                                         norm[crop_idx], label[crop_idx])

        if self.shuffle_index:
            shuf = self.rng.permutation(coord.shape[0])
            coord, color, norm, label = coord[shuf], color[shuf], norm[shuf], label[shuf]

        return self._build_item(coord, norm, color, label)

    def _build_item(self, coord, norm, color, label):
        cfg = self.cfg
        if cfg.get("device_pyramid"):
            # level 0 alone: the pyramid and the edges are built on the
            # device after packing (data/post_knn.build_pyramid_packed)
            return {"point_list": [coord.astype(np.float32)],
                    "surface_normal_list": [norm.astype(np.float32)],
                    "feature_list": color.astype(np.float32),
                    "label_list": label.astype(np.int32)}
        if cfg.post_knn:
            # the host pyramid without edges: the kNN runs on the device
            point_list, norm_list = subsample(coord, norm, grid_size=cfg.grid_size)
            return {"point_list": point_list, "surface_normal_list": norm_list,
                    "feature_list": color.astype(np.float32),
                    "label_list": label.astype(np.int32)}
        return scene_to_item(coord, norm, color, label, cfg.grid_size,
                             cfg.get("K_self", 16), cfg.get("K_forward", 16),
                             cfg.get("K_propagate", 16), rng=self.rng,
                             morton=bool(cfg.get("window_gather")))


class PackedLoader:
    """Batches BATCH_SIZE scenes into padded PackedPyramids with background
    prefetch. Per-process index sharding replaces DistributedSampler."""

    def __init__(self, dataset: ScanNetDataset, batch_size: int,
                 bucket_multiple: int = 8192, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 level_caps: Sequence[int] | None = None,
                 num_workers: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket_multiple = bucket_multiple
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.level_caps = level_caps
        # the reference's DataLoader(num_workers=cfg.NUM_WORKERS): worker
        # threads fetch scenes ahead, in index order
        if num_workers is None:
            num_workers = int(dataset.cfg.get("NUM_WORKERS", 0) or 0)
        self.num_workers = num_workers

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.epoch = epoch  # keys the per-(seed, epoch, idx) RNG

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_index::self.process_count]

    def _scene_windows_fit(self, scene) -> bool:
        """Would this scene's own tiles fit the pinned window sizes? (Scenes
        are tile-aligned in pack_scenes, so tile windows are a per-scene
        property; only evaluated on the rare overflow event.)"""
        cfg = self.dataset.cfg
        tile = cfg.get("window_tile", 128)
        ws, wf, wp = (cfg.get("window_sizes") or (768, 1536, 512))
        if cfg.get("window_size"):
            ws = wf = wp = cfg.window_size
        for key, limit in (("nei_self_list", ws), ("nei_forward_list", wf),
                           ("nei_propagate_list", wp)):
            for e in scene.get(key, []):
                if max_window_uniques(np.asarray(e), tile) > limit:
                    return False
        return True

    def _fits(self, batch, item) -> bool:
        """Would `batch + [item]` still pack under the pinned level caps?"""
        if self.level_caps is None:
            return True
        cfg = self.dataset.cfg
        align = cfg.get("window_tile", 128) if cfg.get("window_gather") else 1

        def up(n):
            return -(-n // align) * align

        for lvl, cap in enumerate(self.level_caps):
            total = up(item["point_list"][lvl].shape[0]) + sum(
                up(s["point_list"][lvl].shape[0]) for s in batch)
            if total > cap:
                return False
        return True

    def _pack(self, batch, windowed: bool = True) -> PackedPyramid:
        cfg = self.dataset.cfg
        window_tile = (cfg.get("window_tile", 128)
                       if windowed and cfg.get("window_gather") else None)
        return pack_scenes(batch, level_caps=self.level_caps,
                           bucket_multiple=self.bucket_multiple,
                           ignore_label=cfg.ignore_label, window_tile=window_tile,
                           window_size=cfg.get("window_size"),
                           window_sizes=cfg.get("window_sizes"))

    def _pack_with_policy(self, batch) -> PackedPyramid | None:
        """Window overflow must degrade, not kill a long training run (an
        augmented outlier scene can exceed the estimated window sizes).
        Policies (cfg.window_overflow):
          'plain' (default): re-pack the batch with plain [M,K] edges:
              correct output, only slower; fine when shapes may vary.
          'drop': remove the offending scene(s) and re-pack: keeps the
              WindowedEdges structure identical across batches.
          'raise': the strict behaviour (tests / explicit pins).
        """
        try:
            return self._pack(batch)
        except WindowOverflow as e:
            policy = self.dataset.cfg.get("window_overflow", "plain")
            if policy == "raise":
                raise
            warnings.warn(f"window overflow ({e}); policy={policy}")
            if policy == "drop":
                keep = [s for s in batch if self._scene_windows_fit(s)]
                return self._pack(keep) if keep else None
            return self._pack(batch, windowed=False)

    def __iter__(self) -> Iterator[PackedPyramid]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(obj) -> bool:
            """Bounded put that aborts when the consumer abandoned the
            iterator: otherwise the thread blocks in q.put forever and leaks
            (its stack and every batch it holds)."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def items():
            """(index, item) stream; with num_workers > 1 scenes are fetched
            by a thread pool ahead of consumption, in index order."""
            idxs = [int(i) for i in self._indices()]
            if self.num_workers <= 1:
                for i in idxs:
                    if stop.is_set():
                        return
                    yield i, self.dataset[i]
                return
            with ThreadPoolExecutor(self.num_workers) as ex:
                lookahead = max(self.num_workers * 2, self.batch_size)
                pending: deque = deque()
                for i in idxs[:lookahead]:
                    pending.append((i, ex.submit(self.dataset.__getitem__, i)))
                nxt = lookahead
                while pending:
                    if stop.is_set():
                        for _, f in pending:
                            f.cancel()
                        return
                    i, fut = pending.popleft()
                    if nxt < len(idxs):
                        pending.append((idxs[nxt],
                                        ex.submit(self.dataset.__getitem__, idxs[nxt])))
                        nxt += 1
                    yield i, fut.result()

        def emit(batch) -> bool:
            """Pack and queue a batch; False when the consumer is gone."""
            p = self._pack_with_policy(batch)
            return p is None or put(p)

        def producer():
            try:
                batch = []
                for i, item in items():
                    if stop.is_set():
                        return
                    if not self._fits(batch, item):
                        # pinned caps: emit a short batch rather than
                        # overflow; every batch keeps its static shapes and
                        # no scene is dropped
                        if not batch:
                            sizes = [p.shape[0] for p in item["point_list"]]
                            raise ValueError(
                                f"scene {i} alone exceeds level_caps "
                                f"{list(self.level_caps)} (sizes {sizes}); "
                                "raise cfg.level_caps_margin or MAX_POINTS_NUM")
                        if not emit(batch):
                            return
                        batch = []
                    batch.append(item)
                    if len(batch) == self.batch_size:
                        if not emit(batch):
                            return
                        batch = []
                if batch and not self.drop_last and not emit(batch):
                    return
            except BaseException as e:  # re-raised in the consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on GeneratorExit (the consumer broke off or
            # dropped the iterator): release the producer
            stop.set()


def estimate_level_caps(datasets, batch_size: int, bucket_multiple: int,
                        sample: int = 16, margin: float = 1.25,
                        seed: int = 0) -> list[int]:
    """Dataset-derived global level caps for pinned-shape batching.

    Samples scenes from each dataset, measures per-level pyramid sizes, and
    sizes every cap to `batch_size * max_level_size * margin` rounded to the
    bucket. Batches that would still overflow (augmentation variance) are
    split by PackedLoader._fits, so the margin trades padding waste against
    occasional short batches, never correctness.
    """
    rng = np.random.default_rng(seed)
    max_sizes: list[np.ndarray] = []
    for ds in datasets:
        for i in rng.permutation(len(ds))[:sample]:
            item = ds[int(i)]
            max_sizes.append(np.array([p.shape[0] for p in item["point_list"]]))
    per_level = np.max(np.stack(max_sizes), axis=0)
    return compute_level_caps(
        [int(s * batch_size * margin) for s in per_level], bucket_multiple)


def estimate_window_sizes(datasets, sample: int = 16, margin: float = 1.3,
                          tile: int = 128, seed: int = 0) -> tuple:
    """Dataset-derived windowed-gather sizes (self, forward, propagate).

    Per-tile unique-neighbor maxima depend on scan density and augmentation,
    so like estimate_level_caps this samples augmented scenes, measures the
    maxima per edge kind, and sizes each window with `margin` headroom
    (rounded up to 128 slots). Tiles that straddle packed scene boundaries
    mix two neighborhoods; the margin covers that too.
    """
    rng = np.random.default_rng(seed)
    mx = {"self": 1, "fwd": 1, "prop": 1}
    for ds in datasets:
        for i in rng.permutation(len(ds))[:sample]:
            item = ds[int(i)]
            for kind, key in (("self", "nei_self_list"), ("fwd", "nei_forward_list"),
                              ("prop", "nei_propagate_list")):
                for e in item.get(key, []):
                    mx[kind] = max(mx[kind], max_window_uniques(e, tile))

    def _round(v):
        return int(-(-int(v * margin) // 128) * 128)

    return (_round(mx["self"]), _round(mx["fwd"]), _round(mx["prop"]))


def getdataLoaders(cfg, process_index: int = 0, process_count: int = 1):
    """Train + val loaders (reference API: scannet_data_loader_color_DDP.py:303-344).

    With cfg.pin_level_caps both loaders share one dataset-derived set of
    level caps, so every packed batch has the same shapes and a captured
    step is captured once (cfg.level_caps is set). With cfg.window_gather and
    no cfg.window_sizes, the window sizes are derived from the data too.
    """
    train_ds = ScanNetDataset(cfg, "training", seed=cfg.manual_seed)
    val_ds = ScanNetDataset(cfg, "validation", seed=cfg.manual_seed + 1)
    level_caps = cfg.get("level_caps")
    if level_caps is None and cfg.get("pin_level_caps"):
        level_caps = estimate_level_caps(
            [train_ds, val_ds], cfg.BATCH_SIZE, cfg.bucket_multiple,
            sample=cfg.get("level_caps_sample", 16),
            margin=cfg.get("level_caps_margin", 1.25), seed=cfg.manual_seed)
        cfg.level_caps = level_caps
    if cfg.get("window_gather") and not cfg.get("window_sizes"):
        cfg.window_sizes = estimate_window_sizes(
            [train_ds, val_ds], sample=cfg.get("level_caps_sample", 16),
            margin=cfg.get("window_margin", 1.3),
            tile=cfg.get("window_tile", 128), seed=cfg.manual_seed)
    train_loader = PackedLoader(
        train_ds, cfg.BATCH_SIZE, bucket_multiple=cfg.bucket_multiple,
        shuffle=True, drop_last=True, seed=cfg.manual_seed,
        process_index=process_index, process_count=process_count,
        level_caps=level_caps)
    val_loader = PackedLoader(
        val_ds, cfg.BATCH_SIZE, bucket_multiple=cfg.bucket_multiple,
        shuffle=False, drop_last=False,
        process_index=process_index, process_count=process_count,
        level_caps=level_caps)
    return train_loader, val_loader, train_ds, val_ds


def getdataLoadersDDP(cfg):
    """Loaders sharded by this process's rank (reference API parity,
    scannet_data_loader_color_DDP.py:286-300): torch.distributed's rank and
    world size where it is initialised, else rank 0 of 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return getdataLoaders(cfg, rank, world)[:2]
