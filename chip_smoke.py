"""Drive pcf_torch's main path on one CUDA card and check every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
  1 device   the card's name, count, and nvidia-smi name / power limit;
  2 build    nvcc builds every kernel from pcf_torch/csrc; ptxas registers,
             static shared memory and spills per kernel (the fused kernels'
             dynamic shared memory depends on the widths: phase 4 prints it);
  3 slice    the flagship PointConvFormer_Segmentation eval forward on the
             bench workload (2 scenes x 20000 points, windowed, the config
             whose conv layers all run the fused kernels), in float32 and
             bfloat16: BN calibrated by one train-mode pass, launch counts
             reset just before one eval forward and read just after (each
             kernel must have launched), then 15 timed repetitions per
             dtype, the two dtypes in turns;
  4 kernels  every kernel call that forward made, replayed on the same
             inputs against the kernel's plain PyTorch version: window_resolve
             bit-exact; the fused kernels in both index modes within
             tolerance; times from CUDA events beside the plain version's,
             the bound and, for the resolve, torch.index_select's; kernel
             B's launch shape per width and point count (points per block,
             O slices, channel ranges, blocks, shared memory, where the
             projection runs) and time over that shape's calls,
             kernel C's tile per width;
  5 model    the entry-size model (2 x 4000 points) on the card against the
             same weights on the CPU, where the plain versions run;
  6 train    the flagship training step (the same batch, AdamW, remat_blocks,
             entry.build_training) in float32 and bfloat16: launch counts
             reset just before one step and read just after (A, B, C and D
             must each launch, and D once for every resolve whose table needs
             a gradient, counted in the step's autograd graph), then 2
             warm-up and 10 timed steps per dtype, the dtypes in turns, and
             the step's own peak memory; every loss must be finite;
  7 scatter  every window_scatter (kernel D) call of that step, replayed
             against its plain version: f32 within 1e-5 of the output's
             scale, bf16 within one bf16 step; times as in phase 4, beside
             index_add_'s, D's time split into the inverse of the
             edge -> row map (its first pass) and the reduction, and how
             many edges overflowed their row's bucket;
  8 grads    one f32 train step at the entry size on the card, the same
             weights and batch on the CPU in f32 and in float64: the loss and
             every BN running statistic after the step, card against CPU;
             the gradient tree's relative error of each f32 step against the
             float64 one (the card's within TRAIN_WITNESS times the CPU's);
             the same three steps with every ReLU and max smooth, where every
             parameter's gradient on the card is within tolerance of the
             CPU's (GRAD_ATOL); and the backward with BatchNorm on its running
             statistics, every parameter's gradient within that tolerance;
  9 fused    phase 3's models with cfg.fused_eval (BatchNorm folded, each conv
             layer's middle one launch of the whole-layer kernel E), f32 and
             bf16: launch counts reset just before one forward and read just
             after (E once per conv layer, B and C never), the f32 logits
             against the standard forward's within the fold tolerance, the
             entry-size model on the card against the CPU, both fused; then
             15 timed forwards per dtype after 2 warm-up, in turns with the
             standard forward of the same dtype, and the forward's own peak
             memory;
 10 layer    every E call of those forwards replayed against its plain
             version (f32 within 1e-4, bf16 within 1e-2 of the output's
             scale, the max-pool shortcut exact); times as in phase 4;
 11 flat     phase 3's f32 model with cfg.flat_geom: the flat window resolve
             once per hoisted stage, each call bit-exact against its plain
             version, the logits against the standard forward's at
             MODEL_TOL, and one timing block, in turns with the standard
             forward.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
The script needs a CUDA card and the repository beside it. `--profile` adds
a torch.profiler breakdown of one eval forward per dtype to phases 3 and 9
and of one train step per dtype to phase 6.
"""

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import torch
from torch.nn import functional as F

# f32 operands round to bf16 partials at most once per (c, w) term: within
# 1e-4 in f32 the two versions differ only in summation order.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 keeps 8 significant bits: a partial rounded to bf16 after an f32 sum
# taken in another order may land one bf16 step (2^-8 relative) away, which
# moves the output by up to ~1e-2 of its scale.
BF16_REL = 1e-2
# whole model, card against CPU, f32: the tolerance tests/test_pallas_model.py
# holds between pcf_tpu's own paths
MODEL_TOL = dict(atol=5e-3, rtol=1e-3)
# H100 SXM published peaks: HBM bytes/s, and
# float32 (CUDA cores) and bf16 (dense tensor cores) operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# above the H100's highest SM clock (1.98 GHz): a sleep of n cycles lasts at
# least n / CLOCK_HZ seconds
CLOCK_HZ = 2.0e9
# eval forwards timed per dtype, after warm-up
FWD_WARMUP, FWD_REPS = 2, 15
# train steps timed per dtype, after warm-up
STEP_WARMUP, STEP_REPS = 2, 10
# window_scatter against its plain version: f32 atomics sum in another order
# (1e-5 of the output's scale); in bf16 the f32 sums may round to
# neighbouring bf16 values, one step being 2^-8 to 2^-7 of the value
SCATTER_F32_REL = 1e-5
SCATTER_BF16_RTOL = 2 ** -7
# gradients, card against CPU, f32: each parameter's within 5e-3 of its
# largest entry (a gradient that is zero but for rounding, a bias that
# BatchNorm cancels, takes 1% of the largest in the tree), rtol 1e-3. The
# train step's gradient has kinks within f32 rounding of these weights (ReLU
# inputs near zero and near-ties of a max over neighbours, after train-mode
# BatchNorm), and two correct f32 steps land on different sides of some. So
# each f32 step is held to a float64 one: the card's gradient tree no
# farther from it than TRAIN_WITNESS times the CPU's (measured on the H100:
# 1.08e-2 against 1.18e-2 with the real kinks, 6.6e-5 against 1.0e-4 with
# them smoothed), and per parameter only with every ReLU and max smooth.
GRAD_ATOL, GRAD_RTOL, GRAD_FLOOR = 5e-3, 1e-3, 1e-2
TRAIN_WITNESS = 2.0
# fused_eval against the standard forward: every Linear+BN pair folded into
# one affine transform, the tolerance tests/test_fused_eval.py holds between
# pcf_tpu's two paths of the whole model
FOLD_TOL = dict(atol=1e-2, rtol=1e-2)

SOURCES = {
    "window_resolve": ("pcf_torch/csrc/window_resolve.cu", "pcf_tpu/ops/window.py:369"),
    "pcf_conv_linear": ("pcf_torch/csrc/pcf_conv_linear.cu",
                        "pcf_tpu/ops/pallas/pconv_kernel.py:466"),
    "pconv_pe_conv_linear": ("pcf_torch/csrc/pconv_fused.cu",
                             "pcf_tpu/ops/pallas/pconv_kernel.py:498"),
    "window_scatter": ("pcf_torch/csrc/window_scatter.cu", "pcf_tpu/ops/window.py:400"),
    "window_resolve_flat": ("pcf_torch/csrc/window_resolve.cu", "pcf_tpu/ops/window.py:545"),
    "fused_layer_eval": ("pcf_torch/csrc/layer_eval.cu", "pcf_tpu/attic/eval_kernel.py:325"),
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2) -> float:
    """Mean device ms of fn() over `reps` runs, from CUDA events, after
    warm-up. A sleep kernel holds the stream for twice the host's time to
    enqueue the runs, so the events time the card's work back to back and
    not the host's launch rate (a wrapper's checks outlast a small
    kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * reps * enqueue_s * CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Wraps a kernel wrapper where the model looks it up, keeping the
    arguments of every call for the replay of phase 4."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)

    def restore(self):
        setattr(self.module, self.name, self.fn)


class KwRecorder(Recorder):
    """A Recorder whose calls keep their keyword arguments: (args, kwargs)."""

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def timed_in_turns(fns: dict, warmup: int, reps: int) -> dict:
    """Host ms of each fn() over `reps` rounds after `warmup`, the fns taking
    turns within a round so that all see the same host load."""
    times = {k: [] for k in fns}
    for i in range(warmup + reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                times[k].append((time.perf_counter() - t) * 1e3)
    return times


def forward_with(model, batch, **keys):
    """fn() running one forward of `model` on `batch` with `keys` set in its
    config (the model's modules share that config)."""
    def run():
        model.cfg.update(keys)
        model.forward_batch(batch)
    return run


def turns_summary(times: dict, valid: int) -> str:
    """Median, min and max ms and valid points/s of each entry of
    timed_in_turns' result."""
    return "; ".join(
        f"{k} median {statistics.median(t):.3f} min {min(t):.3f} max {max(t):.3f} "
        f"({valid / statistics.median(t) * 1e3:.1f} valid points/s)"
        for k, t in times.items())


def forward_peak(fn) -> tuple[int, int]:
    """(peak bytes allocated during fn(), bytes allocated before it)."""
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), resident


def layer_eval_cost(args, kw) -> tuple[int, int]:
    """(bytes, operations) of one fused_layer_eval call: tables, indices,
    centres and weights read once, outputs written once; the MLP,
    guidance-modulation, contraction and projection operations."""
    feats, geo, edges, cxyz, _, wn, pe, gd, lw, lb = args
    M, K = edges.nei.shape
    osz = feats.element_size()
    weights = sum(t.numel() for pairs in (wn, pe, gd) for p in pairs for t in p)
    b = (feats.numel() * feats.element_size() + geo.numel() * 4
         + (edges.window_rows.numel() + edges.localT.numel()) * 4
         + cxyz.numel() * 4 * (2 if kw["use_vi"] else 1)
         + (weights + lw.numel() + lb.numel()) * 4
         + M * (lw.shape[1] + kw.get("Cs", 0)) * osz)
    CtW, O = lw.shape
    ops = M * K * sum(2 * w.shape[0] * w.shape[1] for pairs in (wn, pe, gd) for w, _ in pairs)
    ops += 2 * M * K * CtW + 2 * M * CtW * O + (M * K * kw["Cx"] if gd else 0)
    return b, ops


def profile_run(fn, label, top=12):
    """torch.profiler over one call of fn (an eval forward or a train step):
    device busy time against the wall time, the number of kernels launched,
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # kernels only: an operator's own entry repeats its kernels' device time
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    log(f"[profile] {label}: wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({busy / wall:.1%}), {sum(e.count for e in dev)} device kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile] {label}: {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def grad_ratios(got: dict, want: dict):
    """(parameters beyond tolerance, worst ratio to it, its name): each
    gradient against GRAD_ATOL of its largest entry, floored, and GRAD_RTOL."""
    tree_max = max(g.abs().max().item() for g in want.values())
    over, worst, worst_key = 0, 0.0, None
    for k, w in want.items():
        atol = GRAD_ATOL * max(w.abs().max().item(), GRAD_FLOOR * tree_max)
        ratio = ((got[k] - w).abs() / (atol + GRAD_RTOL * w.abs())).max().item()
        over += ratio > 1.0
        if ratio > worst:
            worst, worst_key = ratio, k
    return over, worst, worst_key


def tree_error(got: dict, want: dict) -> float:
    """|got - want| / |want| over the whole gradient tree (L2)."""
    num = sum((got[k] - w).pow(2).sum().item() for k, w in want.items())
    return math.sqrt(num / sum(w.pow(2).sum().item() for w in want.values()))


@contextlib.contextmanager
def smooth_kinks():
    """Every ReLU and leaky ReLU of the port replaced by softplus (slope*x +
    (1 - slope)*softplus(x) for the leaky one) and every max over neighbours
    (Tensor.amax) by logsumexp, so that the train step's gradient has no
    kink for rounding to cross."""
    relu, leaky_relu, softplus, amax = F.relu, F.leaky_relu, F.softplus, torch.Tensor.amax
    F.relu = lambda x, inplace=False: softplus(x)
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: (
        negative_slope * x + (1 - negative_slope) * softplus(x))
    torch.Tensor.amax = lambda x, dim, keepdim=False: torch.logsumexp(x, dim, keepdim)
    try:
        yield
    finally:
        F.relu, F.leaky_relu, torch.Tensor.amax = relu, leaky_relu, amax


def train_step_grads(cfg, batch, device, dtype):
    """(model, loss, gradients as f64 CPU tensors) of one train step of the
    seed-1 model in `dtype` on `device`."""
    from pcf_torch.entry import build_training

    state, step = build_training(cfg, device=device, seed=1)
    state.model.to(dtype)
    state, metrics = step(state, batch.to(device, dtype), 0)
    return state.model, metrics["loss"].item(), {
        k: p.grad.cpu().double() for k, p in state.model.named_parameters()}


def graph_scatters(root, windowed_edges_cls) -> int:
    """The window_scatter launches that the backward from `root` must make:
    resolve nodes whose table needs a gradient, plus window-mode fused
    nodes whose features need one (their backward gathers through the
    resolve again), in the autograd graph below `root`."""
    seen, stack, n = set(), [root], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        if name == "WindowResolveBackward" and node.needs_input_grad[0]:
            n += 1
        elif (name == "_FusedConvLinearBackward" and node.needs_input_grad[1]
              and isinstance(node.edges, windowed_edges_cls)):
            n += 1
        stack.extend(f for f, _ in node.next_functions)
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    import pcf_torch.nn.fused as fused_mod
    import pcf_torch.nn.fused_eval as fused_eval_mod
    import pcf_torch.ops.kernels.window_resolve as resolve_mod
    import pcf_torch.ops.window as window_mod
    import pcf_torch.parallel.mesh as mesh_mod
    from pcf_torch.entry import build, build_training, flagship_batch
    from pcf_torch.nn.layers import PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE
    from pcf_torch.ops.kernels import build as kbuild
    from pcf_torch.ops.kernels.layer_eval import (fused_layer_eval, fused_layer_eval_plain,
                                                  launch_tile as layer_eval_tile)
    from pcf_torch.ops.kernels.pconv_fused import (
        launch_shape, launch_tile, pconv_pe_conv_linear, pconv_pe_conv_linear_plain,
        pcf_conv_linear, pcf_conv_linear_plain)
    from pcf_torch.ops.kernels.window_resolve import (window_resolve, window_resolve_flat,
                                                      window_resolve_plain,
                                                      windowed_take_flat_plain)
    from pcf_torch.ops.kernels.window_scatter import (bucket_cap, window_scatter,
                                                      window_scatter_inverse, window_scatter_plain)
    from pcf_torch.ops.window import WindowedEdges
    from pcf_torch.train.loss import cross_entropy_loss

    t_start = time.time()
    # ---- 1 device -------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # ---- 2 build --------------------------------------------------------
    t0 = time.time()
    reports = kbuild.build()
    log(f"[build] nvcc {' '.join(kbuild.NVCC_FLAGS)}: {time.time() - t0:.1f} s")
    for src, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                log(f"[build] {src}: {line.strip()}")

    kernels = {"window_resolve": window_resolve, "pcf_conv_linear": pcf_conv_linear,
               "pconv_pe_conv_linear": pconv_pe_conv_linear}
    plains = {"window_resolve": window_resolve_plain,
              "pcf_conv_linear": pcf_conv_linear_plain,
              "pconv_pe_conv_linear": pconv_pe_conv_linear_plain}

    # ---- 3 slice ----------------------------------------------------------
    t0 = time.time()
    cfg, batch = flagship_batch(level0_points=20000, bucket=4096, n_scenes=2,
                                window_gather=True, device="cuda")
    log(f"[slice] batch built in {time.time() - t0:.1f} s: caps "
        f"{[p.shape[0] for p in batch.points]}, valid "
        f"{[int(m.sum()) for m in batch.masks]}")
    cfg.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
    valid = int(batch.masks[0].sum())
    runs, models = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        cfg_d = cfg.copy()
        cfg_d.compute_dtype = dtype_name
        model = build(cfg_d, device="cuda", seed=0)
        with torch.no_grad():
            model.train()
            model.forward_batch(batch)  # BN calibration, as bench.py
            model.eval()
            torch.cuda.synchronize()
            recs = [Recorder(window_mod, "window_resolve"),
                    Recorder(fused_mod, "pcf_conv_linear"),
                    Recorder(fused_mod, "pconv_pe_conv_linear")]
            for fn in kernels.values():
                fn.launches = 0
            logits = model.forward_batch(batch)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
            for r in recs:
                r.restore()
        assert logits.shape == (batch.points[0].shape[0], cfg.num_classes), logits.shape
        assert torch.isfinite(logits[batch.masks[0]]).all(), "non-finite logits"
        for k, n in launches.items():
            assert n > 0, f"{k} was not launched on the main path"
        log(f"[slice] {dtype_name}: launches per eval forward {launches}")
        runs[dtype_name] = dict(launches=launches, calls={r.name: r.calls for r in recs})
        models[dtype_name] = model
        del logits

    # the dtypes take turns, so both see the same host load over the run
    with torch.no_grad():
        times = timed_in_turns({d: functools.partial(m.forward_batch, batch)
                                for d, m in models.items()}, FWD_WARMUP, FWD_REPS)
    for dtype_name, model in models.items():
        # both models and the calls kept for phase 4 stay resident: the
        # forward's own memory is the peak above what was allocated before it
        with torch.no_grad():
            peak, resident = forward_peak(lambda: model.forward_batch(batch))
        if "--profile" in sys.argv:
            with torch.no_grad():
                profile_run(lambda: model.forward_batch(batch), f"{dtype_name} eval forward")
        ts = times[dtype_name]
        med = statistics.median(ts)
        log(f"[slice] {dtype_name}: forward ms median {med:.3f} min {min(ts):.3f} "
            f"max {max(ts):.3f} ({FWD_REPS} reps after {FWD_WARMUP} warm-up, in turns "
            f"with the other dtype); {valid / med * 1e3:.1f} valid points/s; "
            f"peak memory {peak / 2**20:.1f} MiB, of which the forward "
            f"{(peak - resident) / 2**20:.1f} MiB")
    del model  # `models` stays for phases 9-11

    # ---- 4 kernels ------------------------------------------------------
    def bytes_ops(kname, args):
        if kname == "window_resolve":
            table, wr, lt = args
            out = lt.numel() * table.shape[1] * table.element_size()
            return table.numel() * table.element_size() + (wr.numel() + lt.numel()) * 4 + out, 0
        feats, edges, extra, v, lw, lb = args
        M, K, W = v.shape
        C = feats.shape[1]
        E = 0 if extra is None else extra.shape[-1]
        Ct = C if kname == "pcf_conv_linear" else C + E
        idx = (edges.window_rows.numel() + edges.localT.numel()
               if isinstance(edges, WindowedEdges) else edges.numel())
        isz = feats.element_size()
        b = (feats.numel() * isz + idx * 4 + M * K * (E + W) * isz
             + (lw.numel() + lb.numel()) * 4 + M * lw.shape[1] * 4)
        ops = 2 * M * K * Ct * W + 2 * M * Ct * W * lw.shape[1]
        if kname == "pcf_conv_linear":
            ops += M * K * C
        return b, ops

    def nei_mode(args):
        return (args[0], args[1].nei) + tuple(args[2:])

    def bound(kname, calls, dt):
        """(bound ms, "bytes" or "operations", bytes, ops) summed over calls."""
        tot_b = tot_o = 0
        for a in calls:
            b, o = bytes_ops(kname, a)
            tot_b, tot_o = tot_b + b, tot_o + o
        t_bytes, t_ops = tot_b / PEAK_BYTES * 1e3, tot_o / PEAK_OPS[dt] * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                tot_b, tot_o)

    results = {}
    for dtype_name, run in runs.items():
        dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        for kname, calls in run["calls"].items():
            kern, plain = kernels[kname], plains[kname]
            if kname == "pcf_conv_linear":
                shapes = sorted({(a[0].shape[1], a[2].shape[-1], a[3].shape[2], a[3].shape[1],
                                  a[4].shape[1], a[3].shape[0]) for a in calls})
                for C, H, W, K, O, M in shapes:
                    sh = launch_shape(C, K, W, O, M, bf16=dt == torch.bfloat16)
                    same = [a for a in calls if a[3].shape[0] == M and a[4].shape[1] == O
                            and a[0].shape[1] == C]
                    with torch.no_grad():
                        shape_ms = cuda_ms(lambda: [kern(*a) for a in same])
                    log(f"[kernels] {kname} {dtype_name} C={C} H={H} W={W} K={K} O={O} M={M}: "
                        f"{sh['points']} points per block, {sh['o_slices']} O slice(s) of "
                        f"{sh['o_per_slice']}, {sh['c_splits']} channel range(s), grid "
                        f"{sh['blocks']} blocks of {sh['threads']} "
                        f"threads, {sh['smem'] / 1024:.1f} KiB dynamic shared memory, "
                        f"projection on {sh['projection']}; {len(same)} calls, "
                        f"{shape_ms:.3f} ms")
            elif kname == "pconv_pe_conv_linear":
                widths = sorted({(a[0].shape[1], 0 if a[2] is None else a[2].shape[-1],
                                  a[3].shape[2], a[3].shape[1]) for a in calls})
                for C, P, W, K in widths:
                    mt, smem = launch_tile(C, P, W, K)
                    log(f"[kernels] {kname} {dtype_name} C={C} P={P} W={W} K={K}: {mt} points "
                        f"per block, {smem / 1024:.1f} KiB dynamic shared memory")
            # the main path's calls first: the JSON line reports them
            modes = {"window": calls}
            if kname != "window_resolve":
                modes["nei"] = [nei_mode(a) for a in calls]
            for mode, cl in modes.items():
                err = 0.0
                with torch.no_grad():
                    for args in cl:
                        got, want = kern(*args), plain(*args)
                        torch.cuda.synchronize()
                        if kname == "window_resolve":
                            assert torch.equal(got, want), f"{kname} {mode} not bit-exact"
                            continue
                        diff = (got - want).abs().max().item()
                        err = max(err, diff)
                        scale = want.abs().max().item()
                        tol = (F32_TOL if dt == torch.float32 else
                               dict(atol=BF16_REL * scale, rtol=BF16_REL))
                        assert torch.allclose(got, want, **tol), (
                            f"{kname} {dtype_name} {mode}: max err {diff:.3e} "
                            f"(scale {scale:.3e})")
                    ms = cuda_ms(lambda: [kern(*a) for a in cl])
                    plain_ms = cuda_ms(lambda: [plain(*a) for a in cl], reps=3)
                    lib_ms = None
                    if kname == "window_resolve":
                        neis = [torch.gather(wr, 1, lt[:, 0].long()).reshape(-1)
                                for _, wr, lt in cl]
                        lib_ms = cuda_ms(lambda: [torch.index_select(a[0], 0, n)
                                                  for a, n in zip(cl, neis)])
                b_ms, b_by, tot_b, tot_o = bound(kname, cl, dt)
                if mode == "window":
                    results[(kname, dtype_name)] = dict(
                        name=kname, route="cuda", source=SOURCES[kname][0],
                        replaces=SOURCES[kname][1], launches=run["launches"][kname],
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, dtype=dtype_name)
                log(f"[kernels] {kname} {dtype_name} {mode} mode: {len(cl)} calls per "
                    f"forward, max abs err {err:.3e}, kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, library "
                    f"{'-' if lib_ms is None else f'{lib_ms:.3f}'} ms, bound {b_ms:.4f} ms "
                    f"by {b_by} ({tot_b / 1e6:.1f} MB, {tot_o / 1e9:.2f} GOP)")
    del runs

    # ---- 5 model: card against CPU ---------------------------------------
    cfg_s, batch_s = flagship_batch(level0_points=4000, bucket=1024, window_gather=True,
                                    device="cuda")
    cfg_s.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
    gpu_model = build(cfg_s, device="cuda", seed=1)
    with torch.no_grad():
        gpu_model.train()
        gpu_model.forward_batch(batch_s)
        gpu_model.eval()
        got = gpu_model.forward_batch(batch_s).cpu()
        cpu_model = build(cfg_s, device="cpu", seed=1)
        cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
        want = cpu_model.forward_batch(batch_s.to("cpu"))
    m = batch_s.masks[0].cpu()
    err = (got[m] - want[m]).abs().max().item()
    log(f"[model] entry size, f32, card vs CPU plain: max abs err {err:.3e} "
        f"(logit scale {want[m].abs().max().item():.3e})")
    assert torch.allclose(got[m], want[m], **MODEL_TOL), f"model logits differ: {err:.3e}"

    # ---- 6 train ---------------------------------------------------------
    all_kernels = dict(kernels, window_scatter=window_scatter)
    states, train_runs = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        cfg_d = cfg.copy()
        cfg_d.compute_dtype = dtype_name
        states[dtype_name] = build_training(cfg_d, device="cuda", seed=0)
    step_times = {d: [] for d in states}
    losses = {d: [] for d in states}
    for i in range(STEP_WARMUP + STEP_REPS):
        for dtype_name, (state, step) in states.items():
            counted = i == 0
            if counted:
                expected = []
                real_loss = mesh_mod.cross_entropy_loss

                def loss_and_graph(logits, *a, **kw):
                    expected.append(graph_scatters(logits.grad_fn, WindowedEdges))
                    return real_loss(logits, *a, **kw)

                mesh_mod.cross_entropy_loss = loss_and_graph
                rec = Recorder(resolve_mod, "window_scatter")
                torch.cuda.synchronize()
                for fn in all_kernels.values():
                    fn.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch, i)
            loss = metrics["loss"].item()  # waits for the step
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if counted:
                launches = {k: fn.launches for k, fn in all_kernels.items()}
                rec.restore()
                mesh_mod.cross_entropy_loss = real_loss
                for k, n in launches.items():
                    assert n > 0, f"{k} was not launched by the train step"
                assert launches["window_scatter"] == expected[0], (
                    f"window_scatter launched {launches['window_scatter']} times, the "
                    f"step's graph holds {expected[0]} resolves that need a gradient")
                log(f"[train] {dtype_name}: launches per train step {launches} "
                    f"(window_scatter expected {expected[0]})")
                train_runs[dtype_name] = dict(launches=launches, calls=rec.calls)
            losses[dtype_name].append(loss)
            if i >= STEP_WARMUP:
                step_times[dtype_name].append(ms)
    for dtype_name, (state, step) in states.items():
        assert all(math.isfinite(v) for v in losses[dtype_name]), losses[dtype_name]
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, STEP_WARMUP + STEP_REPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if "--profile" in sys.argv:
            profile_run(lambda: step(state, batch, 0), f"{dtype_name} train step")
        ts = step_times[dtype_name]
        med = statistics.median(ts)
        log(f"[train] {dtype_name}: step ms median {med:.3f} min {min(ts):.3f} max "
            f"{max(ts):.3f} ({STEP_REPS} steps after {STEP_WARMUP} warm-up, in turns with "
            f"the other dtype); {valid / med * 1e3:.1f} valid points/s; peak memory "
            f"{peak / 2**20:.1f} MiB, of which the step {(peak - resident) / 2**20:.1f} MiB; "
            f"losses {[round(v, 5) for v in losses[dtype_name]]}")
    del states, state, step

    # ---- 7 scatter: kernel D against its plain version --------------------
    for dtype_name, run in train_runs.items():
        calls = run["calls"]
        err = 0.0
        with torch.no_grad():
            for g, wr, lt, n_rows, dt in calls:
                got, want = window_scatter(g, wr, lt, n_rows, dt), window_scatter_plain(
                    g, wr, lt, n_rows, dt)
                torch.cuda.synchronize()
                scale = want.float().abs().max().item()
                diff = (got.float() - want.float()).abs().max().item()
                err = max(err, diff)
                rtol = 0.0 if dt == torch.float32 else SCATTER_BF16_RTOL
                assert torch.allclose(got.float(), want.float(), rtol=rtol,
                                      atol=SCATTER_F32_REL * scale), (
                    f"window_scatter {dtype_name}: max err {diff:.3e} (scale {scale:.3e})")
            ms = cuda_ms(lambda: [window_scatter(*a) for a in calls])
            inverse_ms = cuda_ms(lambda: [window_scatter_inverse(*a) for a in calls])
            plain_ms = cuda_ms(lambda: [window_scatter_plain(*a) for a in calls], reps=3)
            # the yardstick: one index_add_ over the edges' rows (every row of
            # these windows is in range, so the clamp changes nothing)
            neis = [torch.gather(wr, 1, lt[:, 0].long()).reshape(-1).clamp(0, n - 1)
                    for _, wr, lt, n, _ in calls]

            def library():
                return [torch.zeros(n, g.shape[-1], dtype=torch.float32,
                                    device=g.device).index_add_(
                            0, nei, g.reshape(-1, g.shape[-1]).float())
                        for (g, _, _, n, _), nei in zip(calls, neis)]

            lib_ms = cuda_ms(library)
        # how much of the step's fan-in the buckets hold: the edges past a
        # row's bucket go through the overflow pass
        over = heavy = 0
        for _, wr, lt, n, _ in calls:
            rows = torch.gather(wr, 1, lt[:, 0].long().clamp(0, wr.shape[1] - 1)).reshape(-1)
            counts = torch.bincount(rows[(rows >= 0) & (rows < n)], minlength=n)
            cap = bucket_cap(n, rows.numel())
            over += int((counts - cap).clamp(min=0).sum())
            heavy += int((counts > cap).sum())
        log(f"[scatter] window_scatter {dtype_name}: {sum(a[2].numel() for a in calls)} edges "
            f"per step, {over} past their row's bucket, {heavy} rows overflowed")
        tot_b = sum(g.numel() * g.element_size() + (wr.numel() + lt.numel()) * 4
                    + n * g.shape[-1] * (4 + (2 if dt == torch.bfloat16 else 0))
                    for g, wr, lt, n, dt in calls)
        b_ms = tot_b / PEAK_BYTES * 1e3
        results[("window_scatter", dtype_name)] = dict(
            name="window_scatter", route="cuda", source=SOURCES["window_scatter"][0],
            replaces=SOURCES["window_scatter"][1],
            launches=run["launches"]["window_scatter"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
            dtype=dtype_name)
        log(f"[scatter] window_scatter {dtype_name}: {len(calls)} calls per train step, "
            f"max abs err {err:.3e}, kernel {ms:.3f} ms (inverse {inverse_ms:.3f} ms, "
            f"reduction {ms - inverse_ms:.3f} ms), plain {plain_ms:.3f} ms, "
            f"index_add_ {lib_ms:.3f} ms, bound {b_ms:.4f} ms by bytes "
            f"({tot_b / 1e6:.1f} MB)")
    del train_runs, run, calls

    # ---- 8 grads: card against CPU ---------------------------------------
    # the same step on the CPU in float64 is the reference that both f32
    # steps are held to
    runs8 = {"card": ("cuda", torch.float32), "CPU": ("cpu", torch.float32),
             "f64": ("cpu", torch.float64)}
    steps = {name: train_step_grads(cfg_s, batch_s, dev, dt)
             for name, (dev, dt) in runs8.items()}
    with smooth_kinks():
        smooth = {name: train_step_grads(cfg_s, batch_s, dev, dt)
                  for name, (dev, dt) in runs8.items()}
    (gpu_model, gpu_loss, g_card), (cpu_model, cpu_loss, g_cpu), (_, _, g_64) = (
        steps["card"], steps["CPU"], steps["f64"])
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    e_card, e_cpu = tree_error(g_card, g_64), tree_error(g_cpu, g_64)
    over, _, _ = grad_ratios(g_card, g_cpu)
    log(f"[grads] entry size, one train step: loss card {gpu_loss:.7f} vs CPU "
        f"{cpu_loss:.7f} (rel {rel:.2e}); gradient tree relative L2 error against the "
        f"float64 CPU step: card {e_card:.3e}, CPU {e_cpu:.3e}; card against CPU "
        f"{tree_error(g_card, g_cpu):.3e}, {over} of {len(g_cpu)} parameters beyond the "
        f"per-parameter tolerance")
    s_card, s_cpu, s_64 = (smooth[k][2] for k in ("card", "CPU", "f64"))
    es_card, es_cpu = tree_error(s_card, s_64), tree_error(s_cpu, s_64)
    over_s, worst_s, worst_key_s = grad_ratios(s_card, s_cpu)
    log(f"[grads] the same step with every ReLU and max smooth (softplus, logsumexp): "
        f"against the float64 CPU step card {es_card:.3e}, CPU {es_cpu:.3e}; card "
        f"against CPU: worst gradient {worst_key_s} at {worst_s:.3f} of its tolerance, "
        f"{over_s} beyond it")
    assert rel <= 1e-5, f"train-step loss differs: {rel:.3e}"
    for label, ec, eh in (("", e_card, e_cpu), ("smooth ", es_card, es_cpu)):
        assert ec <= TRAIN_WITNESS * eh, (
            f"the card's {label}train-step gradients are {ec:.3e} from the float64 step, "
            f"more than {TRAIN_WITNESS:g} times the CPU's {eh:.3e}")
    assert over_s == 0, f"smooth train-step gradient {worst_key_s} differs: {worst_s:.3f}"
    cpu_state = cpu_model.state_dict()
    for k, v in gpu_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(v.cpu(), cpu_state[k], **MODEL_TOL), f"BN statistic {k}"
    log("[grads] BN running statistics after the step agree")
    # the same backward with BatchNorm on its running statistics: every kernel
    # of the step (A, B, C forward; D and the fused backward) without the
    # batch statistics' amplification, held per parameter. Both sides take
    # the CPU's weights after the step: AdamW's first step moves a weight by
    # about the learning rate whatever its gradient's size, so a gradient
    # near zero of another sign on the card would move it elsewhere.
    gpu_model.load_state_dict(cpu_model.state_dict())
    grads = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        model.eval()
        model.zero_grad(set_to_none=True)
        b = batch_s.to(next(model.parameters()).device)
        loss, _ = cross_entropy_loss(model.forward_batch(b), b.labels, mask=b.masks[0])
        loss.backward()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    over, worst, worst_key = grad_ratios(grads["cuda"], grads["cpu"])
    log(f"[grads] the same weights, BatchNorm on running statistics: worst gradient "
        f"{worst_key} at {worst:.3f} of its tolerance, {over} beyond it; tree relative "
        f"L2 error {tree_error(grads['cuda'], grads['cpu']):.3e}")
    assert over == 0, f"gradient {worst_key} differs: {worst:.3f} of its tolerance"
    del steps, smooth, gpu_model, cpu_model, grads

    # ---- 9 fused: the folded-BN forward, kernel E --------------------------
    conv_layers = (PointConv, PointConvStridePE, PCFLayer, PointConvTransposePE)
    eval_kernels = dict(kernels, window_resolve_flat=window_resolve_flat,
                        fused_layer_eval=fused_layer_eval)
    fused_runs = {}
    for dtype_name, model in models.items():
        n_conv = sum(isinstance(m, conv_layers) for m in model.modules())
        with torch.no_grad():
            model.cfg.fused_eval = False
            standard = model.forward_batch(batch)
            model.cfg.fused_eval = True
            rec = KwRecorder(fused_eval_mod, "fused_layer_eval")
            torch.cuda.synchronize()
            for fn in eval_kernels.values():
                fn.launches = 0
            logits = model.forward_batch(batch)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in eval_kernels.items()}
            rec.restore()
        assert logits.shape == standard.shape, logits.shape
        assert torch.isfinite(logits[batch.masks[0]]).all(), "non-finite fused logits"
        assert launches["fused_layer_eval"] == n_conv, (
            f"fused_layer_eval launched {launches['fused_layer_eval']} times for "
            f"{n_conv} conv layers: the gate missed a layer")
        assert launches["pcf_conv_linear"] == launches["pconv_pe_conv_linear"] == 0, launches
        m0 = batch.masks[0]
        diff = (logits[m0].float() - standard[m0].float()).abs().max().item()
        log(f"[fused] {dtype_name}: launches per fused eval forward {launches} "
            f"({n_conv} conv layers); logits against the standard forward: max abs err "
            f"{diff:.3e} (scale {standard[m0].float().abs().max().item():.3e})")
        if dtype_name == "float32":
            assert torch.allclose(logits[m0], standard[m0], **FOLD_TOL), (
                f"fused_eval logits differ from the standard forward: {diff:.3e}")
        fused_runs[dtype_name] = dict(launches=launches, calls=rec.calls)
        del logits, standard

    cfg_f = cfg_s.copy()
    cfg_f.fused_eval = True
    gpu_model = build(cfg_f, device="cuda", seed=1)
    with torch.no_grad():
        gpu_model.train()
        gpu_model.forward_batch(batch_s)
        gpu_model.eval()
        n = fused_layer_eval.launches
        got = gpu_model.forward_batch(batch_s).cpu()
        assert fused_layer_eval.launches > n, "the entry-size model did not launch E"
        cpu_model = build(cfg_f, device="cpu", seed=1)
        cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
        want = cpu_model.forward_batch(batch_s.to("cpu"))
    m = batch_s.masks[0].cpu()
    err = (got[m] - want[m]).abs().max().item()
    log(f"[fused] entry size, f32, fused_eval on the card vs the CPU plain version: max "
        f"abs err {err:.3e} (logit scale {want[m].abs().max().item():.3e})")
    assert torch.allclose(got[m], want[m], **MODEL_TOL), f"fused model logits differ: {err:.3e}"
    del gpu_model, cpu_model

    for dtype_name, model in models.items():
        with torch.no_grad():
            ts = timed_in_turns({"fused": forward_with(model, batch, fused_eval=True),
                                 "standard": forward_with(model, batch, fused_eval=False)},
                                FWD_WARMUP, FWD_REPS)
            model.cfg.fused_eval = True
            peak, resident = forward_peak(lambda: model.forward_batch(batch))
            if "--profile" in sys.argv:
                profile_run(lambda: model.forward_batch(batch),
                            f"{dtype_name} fused_eval forward")
            model.cfg.fused_eval = False
        log(f"[fused] {dtype_name}: forward ms, {FWD_REPS} reps after {FWD_WARMUP} warm-up "
            f"in turns: {turns_summary(ts, valid)}; fused forward peak memory "
            f"{(peak - resident) / 2**20:.1f} MiB above resident")

    # ---- 10 layer: kernel E against its plain version ---------------------
    for dtype_name, run in fused_runs.items():
        dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        calls = run["calls"]
        seen = set()
        for args, kw in calls:
            key = (tuple(args[0].shape), tuple(args[2].nei.shape), args[8].shape,
                   kw.get("strided", False))
            if key not in seen:
                seen.add(key)
                mt, smem = layer_eval_tile(*args, **kw)
                log(f"[layer] {dtype_name} table {key[0]} edges {key[1]} linear "
                    f"{tuple(key[2])} strided={key[3]}: {mt} points per block, "
                    f"{smem / 1024:.1f} KiB dynamic shared memory")
        err = 0.0
        with torch.no_grad():
            for args, kw in calls:
                (got, got_s), (want, want_s) = (fused_layer_eval(*args, **kw),
                                                fused_layer_eval_plain(*args, **kw))
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs().max().item()
                err = max(err, diff)
                scale = want.float().abs().max().item()
                tol = (F32_TOL if dt == torch.float32 else
                       dict(atol=BF16_REL * scale, rtol=BF16_REL))
                assert torch.allclose(got.float(), want.float(), **tol), (
                    f"fused_layer_eval {dtype_name}: max err {diff:.3e} (scale {scale:.3e})")
                if want_s is not None:
                    assert torch.equal(got_s, want_s), "fused_layer_eval shortcut differs"
            ms = cuda_ms(lambda: [fused_layer_eval(*a, **k) for a, k in calls])
            plain_ms = cuda_ms(lambda: [fused_layer_eval_plain(*a, **k) for a, k in calls],
                               reps=3)
        tot_b = tot_o = 0
        for args, kw in calls:
            b, o = layer_eval_cost(args, kw)
            tot_b, tot_o = tot_b + b, tot_o + o
        t_bytes, t_ops = tot_b / PEAK_BYTES * 1e3, tot_o / PEAK_OPS[dt] * 1e3
        b_ms, b_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        results[("fused_layer_eval", dtype_name)] = dict(
            name="fused_layer_eval", route="cuda", source=SOURCES["fused_layer_eval"][0],
            replaces=SOURCES["fused_layer_eval"][1],
            launches=run["launches"]["fused_layer_eval"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            dtype=dtype_name)
        log(f"[layer] fused_layer_eval {dtype_name}: {len(calls)} calls per forward, max abs "
            f"err {err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library none, "
            f"bound {b_ms:.4f} ms by {b_by} ({tot_b / 1e6:.1f} MB, {tot_o / 1e9:.2f} GOP)")
    del fused_runs, run, calls

    # ---- 11 flat: flat stage geometry, f32 --------------------------------
    model = models["float32"]
    L = cfg.num_level
    back = cfg.get("resblocks_back", [0] * L)
    n_stages = (int(cfg.use_level_1) + sum(cfg.resblocks[i] > 0 for i in range(1, L))
                + sum(cfg.resblocks[i] != 0 and back[i] > 0 for i in range(L - 1)))
    with torch.no_grad():
        model.cfg.update(fused_eval=False, flat_geom=False)
        standard = model.forward_batch(batch)
        model.cfg.flat_geom = True
        rec = Recorder(window_mod, "window_resolve_flat")
        torch.cuda.synchronize()
        for fn in eval_kernels.values():
            fn.launches = 0
        logits = model.forward_batch(batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in eval_kernels.items()}
        rec.restore()
        m0 = batch.masks[0]
        diff = (logits[m0] - standard[m0]).abs().max().item()
        log(f"[flat] float32: launches per flat_geom forward {launches} ({n_stages} hoisted "
            f"stages); logits against the standard forward: max abs err {diff:.3e}")
        assert launches["window_resolve_flat"] == n_stages, launches
        assert torch.allclose(logits[m0], standard[m0], **MODEL_TOL), (
            f"flat_geom logits differ from the standard forward: {diff:.3e}")
        for args in rec.calls:
            assert torch.equal(window_resolve_flat(*args), windowed_take_flat_plain(*args)), (
                "window_resolve_flat is not bit-exact")
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: [window_resolve_flat(*a) for a in rec.calls])
        plain_ms = cuda_ms(lambda: [windowed_take_flat_plain(*a) for a in rec.calls], reps=3)
        neis = [torch.gather(wr, 1, lt[:, 0].long()).reshape(-1) for _, wr, lt, _ in rec.calls]
        lib_ms = cuda_ms(lambda: [torch.index_select(a[0], 0, n)
                                  for a, n in zip(rec.calls, neis)])
        tot_b = sum(t.numel() * 4 + (wr.numel() + lt.numel()) * 4 + lt.numel() * t.shape[1] * 4
                    for t, wr, lt, _ in rec.calls)
        b_ms = tot_b / PEAK_BYTES * 1e3
        results[("window_resolve_flat", "float32")] = dict(
            name="window_resolve_flat", route="cuda",
            source=SOURCES["window_resolve_flat"][0],
            replaces=SOURCES["window_resolve_flat"][1],
            launches=launches["window_resolve_flat"], max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
            dtype="float32")
        log(f"[flat] window_resolve_flat float32: {len(rec.calls)} calls per forward, "
            f"bit-exact, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, index_select "
            f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms by bytes ({tot_b / 1e6:.2f} MB)")

        ts = timed_in_turns({"flat_geom": forward_with(model, batch, flat_geom=True),
                             "standard": forward_with(model, batch, flat_geom=False)},
                            FWD_WARMUP, FWD_REPS)
        model.cfg.flat_geom = True
        peak, resident = forward_peak(lambda: model.forward_batch(batch))
        model.cfg.flat_geom = False
    log(f"[flat] float32: forward ms, {FWD_REPS} reps after {FWD_WARMUP} warm-up in turns: "
        f"{turns_summary(ts, valid)}; flat_geom forward peak memory "
        f"{(peak - resident) / 2**20:.1f} MiB above resident")
    del models, model, logits, standard, rec

    log(f"[done] {time.time() - t_start:.1f} s")
    # the flat resolve reads geometry, f32 in either dtype: its float32 row
    # stands in both lines
    order = list(all_kernels) + ["window_resolve_flat", "fused_layer_eval"]
    dtypes = {"window_resolve_flat": "float32"}
    log("[kernels float32] " + json.dumps([results[(k, "float32")] for k in order]))
    log(smi)
    print(json.dumps({"kernels": [results[(k, dtypes.get(k, "bfloat16"))] for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
