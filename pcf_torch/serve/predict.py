"""Serve predictions from an exported artifact (no model code needed), the
port of pcf_tpu/serve/predict.py.

Usage:
  python -m pcf_torch.serve.predict --artifact <dir> --scenes 'data/val/*.npz' \
      [--out ./predictions] [--device cuda|cpu]

Each scene npz needs coords [n,3]; feats (colour and normals) are used when
present (matching data/prepare.py output). Writes <scene>.txt label files
and prints per-scene timing, split into the host's work (voxelize, pyramid,
pack), the device call, the copy back and the softmax on the host; the
serving analog of eval/simple. The card is the default device: without one
it raises unless --device cpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

from pcf_torch.serve.export import ServingModel


def load_scene(path: str):
    """prepare.py / make_synth_dataset.py convention: coords [n,3] and
    feats [n,6] = color(3) + normal(3)."""
    with np.load(path) as z:
        coord = z["coords"].astype(np.float32)
        feats = z["feats"].astype(np.float32) if "feats" in z else None
    if feats is None:
        feats = np.ones((len(coord), 3), np.float32)
    if feats.shape[1] >= 6:
        norm = feats[:, 3:6]
    else:
        norm = np.zeros((len(coord), 3), np.float32)
        norm[:, 2] = 1.0
    return coord, norm, feats[:, :3]


def main():
    p = argparse.ArgumentParser("pcf_torch serving CLI")
    p.add_argument("--artifact", required=True)
    p.add_argument("--scenes", required=True, help="glob of scene .npz files")
    p.add_argument("--out", default="./predictions")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    a = p.parse_args()

    model = ServingModel(a.artifact, device=a.device)
    os.makedirs(a.out, exist_ok=True)
    files = sorted(glob.glob(a.scenes))
    times = []
    for f in files:
        coord, norm, feats = load_scene(f)
        t0 = time.perf_counter()
        labels, _probs = model.predict_scene(coord, norm, feats)
        times.append(time.perf_counter() - t0)
        name = os.path.splitext(os.path.basename(f))[0]
        np.savetxt(os.path.join(a.out, f"{name}.txt"), labels, fmt="%d")
        split = ", ".join(f"{k} {v:.3f}" for k, v in model.last_split.items())
        print(f"{name}: {len(labels)} pts in {times[-1]*1e3:.1f} ms ({split} ms)")
    print(json.dumps({"scenes": len(files),
                      "mean_ms": float(np.mean(times) * 1e3) if times else None}))


if __name__ == "__main__":
    main()
