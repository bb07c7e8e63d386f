"""The spread of chip_smoke.py's bf16 fused_eval gate (FUSED_BF16_WITNESS)
over training runs, on the card.

Runs chip_smoke.py's phase 13 (trainer.main on synthetic rooms, then
eval.simple.evaluate with fused_eval from the checkpoint) `runs` times, each
training afresh. For every validation scene it prints the gate's ratio: the
RMS error of the bf16 fused_eval forward against the f32 standard forward,
over the bf16 standard forward's. It gives the ratio for kernel E's replay
and, on the same weights and batch, for two plain PyTorch versions of the
whole-layer evaluation:

  port     ops/kernels/layer_eval.fused_layer_eval_plain: f32 between the
           reads and the projection, S and L rounded to bf16
  pcf_tpu  pcf_tpu's eval kernel's rounding: also the MLPs' multiplicands
           and outputs, features times scores and each contraction product
           rounded to bf16

Phase 13's gates are logged here, not asserted. Needs one card and the
kernels' toolchain, as chip_smoke.py does.

Usage (from the repository root): python3 tools/torch_fused_bf16_spread.py [runs]
"""

from __future__ import annotations

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def pcf_tpu_rounding(feat_table, geo_table, edges, center_xyz, center_norm, wn, pe, gd,
                     linear_w, linear_b, *, Cx, Cg=0, Cs=0, use_vi, pe_on_vi=True,
                     concat_wni=False, strided=False, num_heads=0):
    """The whole-layer evaluation with pcf_tpu's bf16 rounding (a bf16
    feature table only)."""
    from pcf_torch.ops.kernels import layer_eval as le
    from pcf_torch.ops.kernels.window_resolve import window_resolve_plain
    from pcf_torch.ops.vi_transform import VI_coordinate_transform

    f32 = torch.float32

    def bf(t):
        return t.to(torch.bfloat16).to(f32)

    def mlp(x, pairs, final):
        for i, (w, b) in enumerate(pairs):
            x = bf(x) @ bf(w.float()) + b.float()
            x = torch.sigmoid(x) if i == len(pairs) - 1 and final == "sigmoid" else x.relu()
        return bf(x)

    M, K = edges.nei.shape
    W, _, Ct = le._widths(wn, pe, gd, linear_w, Cx=Cx, use_vi=use_vi, concat_wni=concat_wni)
    feats = window_resolve_plain(feat_table, edges.window_rows,
                                 edges.localT).reshape(M, K, -1).float()
    geo = window_resolve_plain(geo_table.float(), edges.window_rows,
                               edges.localT).reshape(M, K, -1)
    loc = geo[..., :3] - center_xyz.float()[:, None, :]
    wni = VI_coordinate_transform(loc, geo[..., 3:6], center_norm.float()) if use_vi else loc
    wgt = mlp(wni, wn, "relu")
    pe_v = None
    if pe:
        pe_v = mlp(wni if pe_on_vi else wni[..., 9:12] if use_vi else wni, pe, "relu")
    elif concat_wni:
        pe_v = bf(wni)
    gath = feats[..., :Cx]
    if gd:
        q = torch.cat([feats[..., Cx:Cx + Cg], pe_v], dim=-1)
        key = q.amax(dim=1, keepdim=True) if strided else q[:, :1]
        gath = bf(gath * mlp(bf(q - key), gd, "sigmoid").repeat(1, 1, Cx // num_heads))
    if Ct > Cx:
        gath = torch.cat([gath, pe_v], dim=-1)
    pc = torch.stack([bf(gath * wgt[..., w:w + 1]).sum(dim=1) for w in range(W)],
                     dim=-1).reshape(M, Ct * W)
    out = (bf(pc) @ bf(linear_w.float()) + linear_b.float()).relu()
    short = feats[..., Cx + Cg:Cx + Cg + Cs].amax(dim=1) if strided else None
    return (out.to(feat_table.dtype),
            None if short is None else short.to(feat_table.dtype))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fused_bf16_spread: this script needs a card", file=sys.stderr)
        return 1
    import pcf_torch.nn.fused_eval as fused_eval_mod
    import pcf_torch.parallel.mesh as mesh_mod
    from pcf_torch.ops.kernels import build as kbuild
    from pcf_torch.ops.kernels.layer_eval import fused_layer_eval, fused_layer_eval_plain
    from pcf_torch.ops.kernels.pconv_fused import pconv_pe_conv_linear, pcf_conv_linear
    from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_flat
    from pcf_torch.ops.kernels.window_scatter import window_scatter

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    versions = {"port": fused_layer_eval_plain, "pcf_tpu": pcf_tpu_rounding}
    ratios = {k: [] for k in ("kernel", *versions)}
    last = {}

    # the eager eval step records the bf16 fused_eval model and batch that
    # phase 13 holds to the f32 forward next
    make_eager = mesh_mod.make_eager_eval_step

    def recording(cfg, *a, **kw):
        step = make_eager(cfg, *a, **kw)

        def run(model, batch):
            if model.cfg.get("fused_eval") and model.cfg.compute_dtype == "bfloat16":
                last["model"], last["batch"] = model, batch
            return step(model, batch)
        return run

    # phase 13 calls rms_diff twice a scene: the fused replay, then the
    # standard bf16 forward, each against the f32 standard forward
    rms_diff = cs.rms_diff
    pending = {}

    def rms(a, b):
        v = rms_diff(a, b)
        if not pending:
            pending["kernel"] = v
            model, batch = last["model"], last["batch"]
            m0 = batch.masks[0]
            kept = fused_eval_mod.fused_layer_eval
            try:
                for name, fn in versions.items():
                    fused_eval_mod.fused_layer_eval = fn
                    with torch.no_grad():
                        pending[name] = rms_diff(model.forward_batch(batch)[m0], b)
            finally:
                fused_eval_mod.fused_layer_eval = kept
        else:
            for k in ratios:
                ratios[k].append(pending[k] / v)
            cs.log("[spread] scene: RMS ratio " + ", ".join(
                f"{k} {ratios[k][-1]:.3f}" for k in ratios) + f" (standard bf16 RMS {v:.4e})")
            pending.clear()
        return v

    gate = cs.FUSED_BF16_WITNESS
    mesh_mod.make_eager_eval_step = recording
    cs.rms_diff = rms
    cs.FUSED_BF16_WITNESS = math.inf

    def same_as_eager(label, got, want, again, dtype_name):
        d = cs.max_diff(got, want)
        limit = cs.GRAPH_REL[dtype_name] * want.float().abs().max().item()
        cs.log(f"[spread] {label}: replay against eager {d:.3e} (gate {limit:.3e}), "
               f"eager against eager {cs.max_diff(again, want):.3e}")

    cs.same_as_eager = same_as_eager
    smi = cs.smi_line()
    cs.log(f"[spread] {smi}")
    kbuild.build()
    wrappers = dict(window_resolve=window_resolve, pcf_conv_linear=pcf_conv_linear,
                    pconv_pe_conv_linear=pconv_pe_conv_linear, window_scatter=window_scatter,
                    window_resolve_flat=window_resolve_flat, fused_layer_eval=fused_layer_eval)
    for i in range(runs):
        t = time.time()
        try:
            cs.entry_phase(wrappers, smi)
        except AssertionError as e:
            cs.log(f"[spread] run {i}: a gate failed: {e}")
        cs.log(f"[spread] run {i}: {time.time() - t:.1f} s")
        torch.cuda.empty_cache()
    for k, v in ratios.items():
        cs.log(f"[spread] {k}: {len(v)} scenes, RMS ratio {min(v):.3f}-{max(v):.3f}, above "
               f"the gate's {gate} in {sum(x > gate for x in v)}: {[round(x, 3) for x in v]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
