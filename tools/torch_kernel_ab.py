"""Kernels B, C and D against an earlier version of their sources, on the
card: the same calls, the same inputs, timed in turns.

    python3 tools/torch_kernel_ab.py OLD_CSRC_DIR

OLD_CSRC_DIR holds an earlier pcf_conv_linear.cu, window_scatter.cu and
conv_tile.cuh with the C interface up to commit 3bfc497 (B and C add split
channel ranges with f32 atomics into a zeroed output; D ranks each edge in
its row's bucket with integer atomics), e.g. `git archive 3bfc497
pcf_torch/csrc` unpacked. They are built with build.NVCC_FLAGS into a
temporary directory and called through ctypes; this tree's kernels through
their wrappers.

The calls: every B and C call of one eval forward and every D call of one
train step of the flagship (entry.flagship_batch(20000, 4096), windowed, as
chip_smoke.py's phases 3 and 6), f32 and bf16; and every B and C call of one
eval forward on 16 synthetic scenes of 15,000 points with plain edges
(flagship_batch(15000, 8192, n_scenes=16): about 190,000 level-0 rows, the
scale of chip_smoke's phase 14). Per group: ms of all its calls by CUDA
events (chip_smoke.cuda_ms: 10 reps after 2 warm-up), old, new, new, old,
the mean of each version's two; the largest difference between the two
versions' outputs against the output's scale; and whether two launches of
the new version on the same inputs give the same bits (the old one's
count of calls that do not); for D also the new calls as the train step
makes them, one inverse per edge set (chip_smoke.shared_calls). Prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build_old(src_dir: str, out_dir: str) -> dict:
    from pcf_torch.ops.kernels import build as kbuild

    procs = {}
    for name in ("pcf_conv_linear", "window_scatter"):
        so = os.path.join(out_dir, f"{name}_old.so")
        procs[name] = (subprocess.Popen([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", so,
                                         os.path.join(src_dir, f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the old {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(so)
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for fn in (libs["pcf_conv_linear"].pcf_conv_linear,
               libs["pcf_conv_linear"].pconv_pe_conv_linear):
        fn.argtypes = [i, vp, i, i, vp, vp, vp, i, i, vp, i, vp, i, vp, vp, i, vp, i, i, vp]
        fn.restype = i
    ws = libs["window_scatter"]
    ws.window_scatter.argtypes = [i, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    ws.window_scatter.restype = i
    ws.window_scatter_workspace.argtypes = [i, ll, i]
    ws.window_scatter_workspace.restype = ll
    return libs


def old_conv(lib, name, feats, edges, extra, weights, lw, lb):
    """The old kernel B or C on the operands that the new wrapper takes (the
    operand checks are the new wrapper's, already passed)."""
    from pcf_torch.ops.kernels.pconv_fused import _bf16_weight, _common_dtype
    from pcf_torch.ops.window import WindowedEdges

    if extra is None:
        extra = weights.new_empty(weights.shape[:2] + (0,))
    feats, extra, weights = _common_dtype(feats, extra, weights)
    bf16 = feats.dtype == torch.bfloat16
    if bf16:
        lw = _bf16_weight(lw, True)
    M, K, W = weights.shape
    if isinstance(edges, WindowedEdges):
        nei, wr, lt = None, edges.window_rows.data_ptr(), edges.localT.data_ptr()
        wsz, mtk = edges.window_rows.shape[1], edges.localT.shape[-1]
    else:
        nei, wr, lt, wsz, mtk = edges.data_ptr(), None, None, 0, 0
    O = lb.shape[0]
    out = torch.empty((M, O), dtype=torch.float32, device=feats.device)
    err = getattr(lib, name)(int(bf16), feats.data_ptr(), feats.shape[0], feats.shape[1], nei,
                             wr, lt, wsz, mtk, extra.data_ptr(), extra.shape[-1],
                             weights.data_ptr(), W, lw.data_ptr(), lb.data_ptr(), O,
                             out.data_ptr(), M, K, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"old {name}: CUDA error {err}"
    return out


def old_scatter(lib, g, window_rows, localT, n_rows, dtype):
    T, MtK, C = g.shape
    ws = torch.empty(lib.window_scatter_workspace(n_rows, T * MtK, C), dtype=torch.uint8,
                     device=g.device)
    out = torch.empty((n_rows, C), dtype=dtype, device=g.device)
    esz = g.element_size()
    chunk = next(c for c in (16, 8, 4, 2)
                 if c >= esz and (C * esz) % c == 0 and g.data_ptr() % c == 0)
    err = lib.window_scatter(int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16),
                             g.data_ptr(), window_rows.data_ptr(), localT.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), T, MtK, window_rows.shape[1],
                             n_rows, C, chunk, 0, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"old window_scatter: CUDA error {err}"
    return out


def compare(label, calls, old_fn, new_fn):
    """Time old and new over `calls` in turns, hold their outputs to each
    other and the new one to itself."""
    diff = scale = 0.0
    unstable_old = 0
    with torch.no_grad():
        for a in calls:
            o, n = old_fn(*a), new_fn(*a)
            assert torch.equal(n, new_fn(*a)), f"{label}: two new launches differ"
            unstable_old += not torch.equal(o, old_fn(*a))
            diff = max(diff, (o.float() - n.float()).abs().max().item())
            scale = max(scale, n.float().abs().max().item())
        t = [cs.cuda_ms(lambda f=f: [f(*a) for a in calls]) for f in (old_fn, new_fn, new_fn,
                                                                        old_fn)]
    old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    cs.log(f"[ab] {label}: {len(calls)} calls, old {old_ms:.4f} ms, new {new_ms:.4f} ms "
           f"({new_ms / old_ms:.3f}x; turns {[round(x, 4) for x in t]}); outputs apart by "
           f"{diff:.3e} (scale {scale:.3e}); new bit-stable in every call, old not in "
           f"{unstable_old}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import pcf_torch.nn.fused as fused_mod
    import pcf_torch.ops.kernels.window_resolve as resolve_mod
    from pcf_torch.entry import build, build_training, flagship_batch
    from pcf_torch.ops.kernels import build as kbuild
    from pcf_torch.ops.kernels.pconv_fused import pconv_pe_conv_linear, pcf_conv_linear
    from pcf_torch.ops.kernels.window_scatter import window_scatter
    from pcf_torch.parallel.mesh import make_eager_train_step

    cs.log(f"[ab] {cs.smi_line()}")
    kbuild.build()
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    libs = build_old(sys.argv[1], tmp)
    new = {"pcf_conv_linear": pcf_conv_linear, "pconv_pe_conv_linear": pconv_pe_conv_linear}

    def conv_groups(cfg, batch, tag):
        for dtype_name in ("float32", "bfloat16"):
            cfg_d = cfg.copy()
            cfg_d.update(compute_dtype=dtype_name, USE_PALLAS_KERNEL=True, fused_min_points=0,
                         resolve_impl="pallas")
            model = build(cfg_d, device="cuda", seed=0)
            recs = [cs.Recorder(fused_mod, k) for k in new]
            with torch.no_grad():
                model.train()
                model.forward_batch(batch)
                model.eval()
                for r in recs:
                    r.calls.clear()
                model.forward_batch(batch)
            for r in recs:
                r.restore()
                compare(f"{tag} {r.name} {dtype_name}", r.calls,
                        lambda *a, n=r.name: old_conv(libs["pcf_conv_linear"], n, *a),
                        new[r.name])
            del model, recs

    cfg, batch = flagship_batch(level0_points=20000, bucket=4096, n_scenes=2, window_gather=True,
                                device="cuda")
    conv_groups(cfg, batch, "flagship eval forward, windowed:")
    for dtype_name in ("float32", "bfloat16"):
        cfg_d = cfg.copy()
        cfg_d.update(compute_dtype=dtype_name, USE_PALLAS_KERNEL=True, fused_min_points=0,
                     resolve_impl="pallas")
        state, _ = build_training(cfg_d, device="cuda", seed=0)
        rec = cs.Recorder(resolve_mod, "window_scatter")
        make_eager_train_step(cfg_d)(state, batch, 0)
        rec.restore()
        compare(f"flagship train step: window_scatter {dtype_name}", rec.calls,
                lambda *a: old_scatter(libs["window_scatter"], *a), window_scatter)
        shared = [cs.cuda_ms(lambda: cs.shared_calls(window_scatter, rec.calls))
                  for _ in range(2)]
        cs.log(f"[ab] flagship train step: window_scatter {dtype_name}, the new calls as the "
               f"step makes them (one inverse per edge set): {sum(shared) / 2:.4f} ms")
        del state, rec
    del batch
    torch.cuda.empty_cache()
    cfg, batch = flagship_batch(level0_points=15000, bucket=8192, n_scenes=16,
                                window_gather=False, device="cuda")
    cs.log(f"[ab] 16 scenes, plain edges: level caps {[p.shape[0] for p in batch.points]}, "
           f"valid {[int(m.sum()) for m in batch.masks]}")
    conv_groups(cfg, batch, "16-scene eval forward, plain edges:")
    shutil.rmtree(tmp, ignore_errors=True)
    print("torch_kernel_ab: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
