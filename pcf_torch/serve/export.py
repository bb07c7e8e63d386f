"""Ahead-of-time export for production serving, the port of
pcf_tpu/serve/export.py.

pcf_tpu serializes its jitted eval forward with jax.export, one program per
bucket shape, and serves it without flax or the model code. The port does
the same with torch.export: the eval forward, traced once per bucket shape
and platform under torch.no_grad(), is an ExportedProgram whose graph calls
the port's kernels as torch custom operators (pcf::window_resolve,
pcf::window_resolve_flat, pcf::conv_linear, pcf::layer_eval: ops/kernels/),
so loading it needs torch, numpy and those operators, not pcf_torch.models
or pcf_torch.nn. The weights derived for the kernels (the BatchNorm folds of
fused_eval) are computed inside the program from its parameters
(ops/kernels/derived.py). On the card, ServingModel captures each bucket's
program as a CUDA graph at its first call and replays it after that
(parallel/graphs.StepGraphs), the counterpart of a compiled executable.

Artifact layout (a directory):
  meta.json                  pcf_tpu's keys: config snapshot, bucket table,
                             format version; each bucket also maps its
                             platforms to their files ("files")
  params.npz                 the model's state_dict (parameters and BN
                             running statistics) by name, stored once
  bucket_<i>.<platform>.pt2  torch.export.save of bucket i's program traced
                             on `platform` ("cpu" or "cuda")

A traced program has its device baked in, so where pcf_tpu writes one
multi-platform file per bucket the port writes one file per platform. The
programs take (flat_params, feats, points, edges_self, edges_forward,
edges_propagate, norms, masks), flat_params the {name: tensor} dict of
params.npz and each WindowedEdges the tuple (nei, window_rows, localT)
(_batch_args), and hold no weights of their own.

Usage:
  python -m pcf_torch.serve.export --config pcf_torch/configs/<name>.json
      --pretrain_path <exp>/model --out <artifact> [--platforms cuda,cpu]
      [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

# registers the custom operators that the programs call
import pcf_torch.ops.kernels.layer_eval  # noqa: F401
import pcf_torch.ops.kernels.pconv_fused  # noqa: F401
from pcf_torch import resolve_device
from pcf_torch.ops.window import edges_as_args, edges_from_args

FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


def _batch_args(batch):
    """The exported calling convention's positional batch arguments:
    pcf_tpu's, each WindowedEdges as (nei, window_rows, localT)."""
    def edges(es):
        return [edges_as_args(e) for e in es]

    return (batch.feats, list(batch.points), edges(batch.edges_self),
            edges(batch.edges_forward), edges(batch.edges_propagate),
            list(batch.norms), list(batch.masks))


def _bucket_key(batch) -> tuple:
    return tuple(int(p.shape[0]) for p in batch.points)


def _json_safe(obj):
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _platforms(platforms) -> list:
    """The platforms to export for: those asked for, else the card's, raising
    without one."""
    if not platforms:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass platforms=['cpu'] to "
                               "export for the CPU")
        return ["cuda"]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad} not among {list(PLATFORMS)}")
    return list(platforms)


class _Forward(torch.nn.Module):
    """The eval forward with every tensor of the model an argument. The model
    is kept out of the module's registry, so the exported program holds no
    weights: its state_dict and constants are empty."""

    def __init__(self, model):
        super().__init__()
        self.__dict__["model"] = model.eval()

    def forward(self, flat_params, feats, points, edges_self, edges_forward,
                edges_propagate, norms, masks):
        def edges(es):
            return [edges_from_args(e) for e in es]

        return torch.func.functional_call(
            self.model, flat_params,
            (feats, points, edges(edges_self), edges(edges_forward),
             edges(edges_propagate), norms), {"masks": masks})


def _drop_noops(program) -> None:
    """Remove from an exported program the nodes that do nothing at run time,
    about 40% of them: dtype conversions of a tensor to its own dtype (the
    model's modules cast to their compute dtype whatever comes in), the
    metadata asserts recorded beside them and the promote_types left unused.
    A program without them saves and loads in about half the time."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) <= 3
              and not node.kwargs.get("copy") and node.kwargs.get("memory_format") is None
              and node.meta["val"].dtype == node.args[0].meta["val"].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    graph.eliminate_dead_code()
    program.graph_module.recompile()


def export_artifact(cfg, model_or_state, out_dir: str, example_batches,
                    platforms: Sequence[str] | None = None, timings: list | None = None
                    ) -> dict:
    """Export the eval forward for every distinct bucket shape and platform.

    model_or_state: a PointConvFormer_Segmentation of `cfg` or its
    state_dict. example_batches: PackedPyramid batches (only shapes matter).
    platforms: drawn from "cpu" and "cuda"; None exports for the card and
    raises without one. Returns the meta dict. `timings`, if given, receives
    (bucket index, platform, export seconds, file bytes) per program."""
    from pcf_torch.models import PointConvFormer_Segmentation

    platforms = _platforms(platforms)
    os.makedirs(out_dir, exist_ok=True)
    state = (model_or_state.state_dict() if isinstance(model_or_state, torch.nn.Module)
             else model_or_state)
    flat = {k: v.detach().cpu() for k, v in state.items()}
    np.savez(os.path.join(out_dir, "params.npz"), **{k: v.numpy() for k, v in flat.items()})
    with torch.device("meta"):
        fwd = _Forward(PointConvFormer_Segmentation(cfg))

    buckets, seen = [], set()
    for batch in example_batches:
        key = _bucket_key(batch)
        if key in seen:
            continue
        seen.add(key)
        i = len(buckets)
        files = {}
        for platform in platforms:
            dev = torch.device(platform)
            args = ({k: v.to(dev) for k, v in flat.items()}, *_batch_args(batch.to(dev)))
            t = time.perf_counter()
            with torch.no_grad():
                program = torch.export.export(fwd, args, strict=False)
            _drop_noops(program)
            files[platform] = f"bucket_{i}.{platform}.pt2"
            path = os.path.join(out_dir, files[platform])
            torch.export.save(program, path)
            if timings is not None:
                timings.append((i, platform, time.perf_counter() - t, os.path.getsize(path)))
        buckets.append({"file": files[platforms[0]], "files": files,
                        "level_caps": list(key)})

    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": platforms,
        "num_classes": int(cfg.num_classes),
        "grid_size": list(cfg.grid_size),
        "K_self": _json_safe(cfg.get("K_self")),
        "K_forward": _json_safe(cfg.get("K_forward")),
        "K_propagate": _json_safe(cfg.get("K_propagate")),
        "bucket_multiple": int(cfg.get("bucket_multiple", 8192)),
        "ignore_label": int(cfg.get("ignore_label", -100)),
        # serving packs with the window geometry the programs were traced
        # with: their calling convention pins the WindowedEdges shapes
        "window": ({"tile": int(cfg.get("window_tile", 128)),
                    "sizes": _json_safe(list(cfg.window_sizes))
                    if cfg.get("window_sizes") else None,
                    "size": _json_safe(cfg.get("window_size"))}
                   if cfg.get("window_gather") else None),
        "buckets": buckets,
        "cfg": _json_safe(dict(cfg)),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ServingModel:
    """Loads an exported artifact and serves predictions.

    Needs torch, numpy, the kernels' operators and the host pipeline of
    predict_scene (voxelize, pyramid, packing), never pcf_torch.models or
    pcf_torch.nn: the forward is the loaded program of the batch's bucket.
    `device` defaults to the card and raises without one; pass "cpu" to
    serve the CPU programs. On the card each bucket's program is captured as
    a CUDA graph at its first call, which runs eagerly, and replayed after
    that (`graphs`); on the CPU it runs eagerly. `programs` holds the loaded
    ExportedPrograms by bucket key. After predict_scene,
    `last_split` holds its milliseconds: host (voxelize, pyramid, pack),
    device (the program, waited for), copy (the logits to the host) and post
    (softmax and broadcast to the raw points).
    """

    def __init__(self, out_dir: str, device=None):
        from pcf_torch.parallel.graphs import StepGraphs

        self.device = resolve_device(device)
        with open(os.path.join(out_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {self.meta['format_version']}, this "
                             f"reader takes {FORMAT_VERSION}")
        platform = self.device.type
        with np.load(os.path.join(out_dir, "params.npz")) as z:
            self.flat_vars = {k: torch.from_numpy(z[k]).to(self.device) for k in z.files}
        self.programs, self._inputs = {}, {}
        for b in self.meta["buckets"]:
            if platform not in b.get("files", {}):
                raise ValueError(f"bucket {b['level_caps']} has no {platform} program "
                                 f"(have {sorted(b.get('files', {}))}); re-export with "
                                 f"--platforms {platform}")
            key = tuple(b["level_caps"])
            program = torch.export.load(os.path.join(out_dir, b["files"][platform]))
            self.programs[key] = program
            self._inputs[key] = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                                 for n in program.graph.nodes if n.op == "placeholder"]
        self._stamp = tuple(t.data_ptr() for t in self.flat_vars.values())
        self.graphs = StepGraphs()
        self.last_split = None

    @property
    def bucket_keys(self):
        return sorted(self.programs)

    def _run(self, key, batch):
        """The program of bucket `key` on `batch`, through its graph module:
        the inputs are flattened here and held to the program's placeholders
        (ExportedProgram.module() checks them by guard code whose generation
        grows with the square of the inputs: tens of seconds for the
        flagship's 1,640 tensors)."""
        program = self.programs[key]
        flat, spec = tree_flatten(((self.flat_vars, *_batch_args(batch)), {}))
        if spec != program.call_spec.in_spec:
            raise ValueError(f"bucket {key}: the inputs' structure differs from the "
                             f"program's calling convention")
        for i, (t, (shape, dtype)) in enumerate(zip(flat, self._inputs[key], strict=True)):
            if (tuple(t.shape), t.dtype) != (shape, dtype):
                raise ValueError(f"bucket {key}: input {i} is {t.dtype} {tuple(t.shape)}, "
                                 f"the program takes {dtype} {shape}")
        with torch.no_grad():
            out = program.graph_module(*flat)
        return tree_unflatten(list(out), program.call_spec.out_spec)

    def predict_packed(self, batch):
        """Logits [N0, num_classes] on the serving device for a PackedPyramid
        in a known bucket (moved to the device)."""
        key = _bucket_key(batch)
        if key not in self.programs:
            raise KeyError(
                f"batch bucket {key} not in artifact (have {self.bucket_keys});"
                " re-export with this bucket or repack with its level_caps")
        if self.device.type != "cuda":
            return self._run(key, batch.to(self.device))
        logits, replayed = self.graphs.run(key, batch.signature(), self._stamp,
                                           lambda b: self._run(key, b), batch, self.device)
        return logits.clone() if replayed else logits

    def pack_scene(self, coord, norm, feats, rng=None):
        """(batch, inverse): one raw scene as predict_scene packs it (shift to
        origin, deterministic voxelize at grid_size[0], host pyramid, the
        smallest fitting artifact bucket with the artifact's window
        geometry), and each raw point's voxel row."""
        from pcf_torch.core.batching import pack_scenes
        from pcf_torch.data.pyramid import scene_to_item
        from pcf_torch.ops.voxelize import voxel_cell_ids, voxelize

        m = self.meta
        coord = coord.astype(np.float32) - coord.min(0)
        uniq_idx = voxelize(coord, m["grid_size"][0], mode="deterministic")
        # raw point -> voxel group, in the same unique-cell-id order that
        # 'deterministic' lists the representatives in
        _, inverse = np.unique(voxel_cell_ids(coord, m["grid_size"][0]),
                               return_inverse=True)
        item = scene_to_item(
            coord[uniq_idx], norm.astype(np.float32)[uniq_idx],
            feats.astype(np.float32)[uniq_idx],
            np.zeros(len(uniq_idx), np.int32), m["grid_size"],
            m["K_self"], m["K_forward"], m["K_propagate"],
            rng=rng or np.random.default_rng(0),
            morton=m.get("window") is not None)
        caps = [list(k) for k in self.bucket_keys]
        sizes = [len(p) for p in item["point_list"]]
        fit = [c for c in caps if all(s <= cc for s, cc in zip(sizes, c))]
        if not fit:
            raise ValueError(
                f"scene pyramid sizes {sizes} exceed every artifact bucket "
                f"{caps}; re-export with a scene this large in the bucket set")
        win = m.get("window")
        try:
            batch = pack_scenes([item], level_caps=min(fit),
                                ignore_label=m["ignore_label"],
                                window_tile=win["tile"] if win else None,
                                window_size=win.get("size") if win else None,
                                window_sizes=win.get("sizes") if win else None)
        except ValueError as e:  # WindowOverflow: the traced shapes are
            # pinned, so there is no plain-edge fallback inside a windowed
            # artifact; fail with the remedy spelled out
            raise ValueError(
                f"scene overflows the artifact's window sizes ({e}); "
                "re-export with larger window_sizes or window_gather=false"
            ) from e
        return batch, inverse

    def predict_scene(self, coord, norm, feats, rng=None):
        """Full serving path for one raw scene, mirroring the eval pipeline
        (data/scannet.py): pack_scene, forward, then broadcast each voxel's
        prediction back to every raw point in that voxel. Returns (labels
        [n], probs [n, C]) in input order."""
        t0 = time.perf_counter()
        batch, inverse = self.pack_scene(coord, norm, feats, rng)
        t1 = time.perf_counter()
        logits = self.predict_packed(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        z = logits[batch.masks[0].to(self.device)].float().cpu().numpy()
        t3 = time.perf_counter()
        z = z[inverse]
        e = np.exp(z - z.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        labels = probs.argmax(-1)
        t4 = time.perf_counter()
        self.last_split = {"host": (t1 - t0) * 1e3, "device": (t2 - t1) * 1e3,
                           "copy": (t3 - t2) * 1e3, "post": (t4 - t3) * 1e3}
        return labels, probs


def parse_args(argv=None):
    """The command line's arguments (sys.argv[1:] when argv is None)."""
    p = argparse.ArgumentParser("pcf_torch AOT export")
    p.add_argument("--config", required=True)
    p.add_argument("--pretrain_path", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="validation",
                   help="split whose scenes define the bucket shapes")
    p.add_argument("--max_scenes", type=int, default=8)
    p.add_argument("--platforms", default=None,
                   help="comma-separated, e.g. cuda,cpu (default: cuda)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv=None):
    """`python -m pcf_torch.serve.export` with these arguments; a .json
    config loads without yaml."""
    from pcf_torch.config import load_config
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.scannet import ScanNetDataset
    from pcf_torch.entry import build_eval
    from pcf_torch.train.checkpoint import CheckpointManager

    a = parse_args(argv)
    platforms = _platforms(a.platforms.split(",") if a.platforms else None)
    cfg = load_config(a.config, a.overrides)
    dataset = ScanNetDataset(cfg, split=a.split, seed=cfg.manual_seed)
    if cfg.get("window_gather") and not cfg.get("window_sizes"):
        # derive and persist window sizes exactly like the train loader, so
        # the artifact serves the benched windowed execution strategy
        from pcf_torch.data.scannet import estimate_window_sizes

        cfg.window_sizes = estimate_window_sizes(
            [dataset], sample=cfg.get("level_caps_sample", 16),
            margin=cfg.get("window_margin", 1.3),
            tile=cfg.get("window_tile", 128), seed=cfg.manual_seed)
        print(f"derived window_sizes {tuple(cfg.window_sizes)}")
    batches = []
    for i in range(min(a.max_scenes, len(dataset))):
        batches.append(pack_scenes(
            [dataset[i]], bucket_multiple=cfg.bucket_multiple,
            level_caps=cfg.get("level_caps"), ignore_label=cfg.ignore_label,
            window_tile=(cfg.get("window_tile", 128)
                         if cfg.get("window_gather") else None),
            window_size=cfg.get("window_size"),
            window_sizes=cfg.get("window_sizes")))

    model, _ = build_eval(cfg, device="cpu")
    if a.pretrain_path:
        # optimizer-independent restore (CheckpointManager.restore_eval)
        params, batch_stats, ep = CheckpointManager(a.pretrain_path).restore_eval()
        if params is None:
            raise FileNotFoundError(f"no checkpoint at {a.pretrain_path}")
        model.load_state_dict({**params, **batch_stats})
        print(f"restored checkpoint epoch {ep} from {a.pretrain_path}")

    timings = []
    meta = export_artifact(cfg, model, a.out, batches, platforms, timings=timings)
    for i, platform, s, nbytes in timings:
        print(f"exported bucket {i} {platform} in {s:.3f} s ({nbytes} bytes)")
    print(f"params.npz {os.path.getsize(os.path.join(a.out, 'params.npz'))} bytes")
    print(json.dumps({"out": a.out,
                      "buckets": [bk["level_caps"] for bk in meta["buckets"]],
                      "platforms": meta["platforms"]}))


if __name__ == "__main__":
    main()
