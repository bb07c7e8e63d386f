"""Drive pcf_torch's main path on one CUDA card and check every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed; each
ends with a line `[time] phase N: S s`):
  1 device   the card's name, count, and nvidia-smi name / power limit;
  2 build    nvcc builds every kernel from pcf_torch/csrc, one process per
             source (layer_eval.cu as 8 translation units and
             pcf_conv_linear.cu as 5, kernel instantiations split over
             them: build.PARTS), all at once, each source's seconds printed;
             ptxas registers, static shared memory and spills per kernel
             (the fused kernels' dynamic shared memory depends on the
             widths: phase 4 prints it);
  3 slice    the flagship PointConvFormer_Segmentation eval forward on the
             bench workload (2 scenes x 20000 points, windowed, the config
             whose conv layers all run the fused kernels), in float32 and
             bfloat16: BN calibrated by one train-mode pass, launch counts
             reset just before one eval forward and read just after (each
             kernel must have launched), then FWD_REPS timed repetitions
             per dtype, the two dtypes in turns;
  4 kernels  every kernel call that forward made, replayed on the same
             inputs against the kernel's plain PyTorch version: window_resolve
             bit-exact; the fused kernels in both index modes within
             tolerance, and each of their calls launched twice on the same
             inputs, equal bit for bit (B and C are deterministic: split
             channel ranges meet in a workspace in range order), at every
             flagship width in both dtypes; times from CUDA events beside the plain version's,
             the bound and, for the resolve, torch.index_select's; kernel
             A's launch plan per call shape (table type and width, edges,
             window; route, unit, lanes per edge, grid, shared memory) with
             its calls, time and bound; kernels B's and C's launch shape per
             width and point count (points per block, O slices, channel
             ranges, blocks, shared memory, where the contraction and the
             projection run) and time over that shape's calls;
  5 model    the entry-size model (2 x 4000 points) on the card against the
             same weights on the CPU, where the plain versions run;
  6 train    the flagship training step (the same batch, AdamW, remat_blocks,
             entry.build_training) in float32 and bfloat16: launch counts
             reset just before one step and read just after (A, B, C and D
             must each launch, and D once for every resolve whose table needs
             a gradient, counted in the step's autograd graph), then 2
             warm-up and STEP_REPS timed steps per dtype, in turns, and
             the step's own peak memory; every loss must be finite; every
             window_resolve call of the counted step replayed bit-exact
             against its plain version, and timed beside its bound;
  7 scatter  every window_scatter (kernel D) call of that step, replayed
             against its plain version: f32 within 1e-5 of the output's
             scale, bf16 within one bf16 step; each call launched twice,
             equal bit for bit (D sorts the edges by row, stably, and sums
             in a fixed order); times as in phase 4, beside index_add_'s,
             D's time as the step runs its calls (one inverse of the
             edge -> row map per edge set: shared_inverses) and each call
             alone, the inverses' (key, radix sort, row offsets) share of
             the latter, and how many edges lie in heavy rows (summed piece
             by piece);
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
             FWD_REPS timed forwards per dtype after 2 warm-up, in turns with the
             standard forward of the same dtype, and the forward's own peak
             memory;
 10 layer    E's launch shape per layer shape (as phase 4's, with the
             per-edge stage's chunk and the split tiles' workspace) and time
             over that shape's calls; every E call of those forwards
             replayed against its plain version (f32 within 1e-4, bf16
             within 1e-2 of the output's scale, the max-pool shortcut
             exact); times as in phase 4;
 11 flat     phase 3's f32 model with cfg.flat_geom: the flat window resolve
             once per hoisted stage, each call bit-exact against its plain
             version, the logits against the standard forward's at
             MODEL_TOL, and one timing block, in turns with the standard
             forward;
 12 graphs   the steps as a user calls them on the card, each captured once
             per bucket signature as a CUDA graph and replayed
             (parallel/graphs.py). Eval (make_eval_step) on phase 3's models:
             the standard and fused_eval forwards in f32 and bf16 and the
             flat_geom forward in f32: no call of B, C or E in the eager
             forward differs between two launches, and each replay's logits
             equal the eager forward's on the same batch bit for bit
             (same_as_eager, exact), then a second batch
             of other scenes packed to the same signature, which must replay
             the same graph; one profiled replay must show each hand-written
             kernel by its CUDA symbol as many times as phases 3, 9 and 11
             counted it; FWD_REPS replays after 2 warm-up in turns with the eager
             forward, the device-busy share of the profiled replay, the
             capture's time and its pool's memory. Train (entry.build_training):
             3 captured and 3 eager f32 steps from the same weights, without
             and with dropout and DropPath (the registered generator): losses
             within GRAPH_LOSS_RTOL, parameters within phase 8's tolerance;
             the bf16 L copies and BN folds after replays against a fresh
             model loaded with the trained weights; per dtype the replay's
             kernels (phase 6's counts) and STEP_REPS steps after 2 warm-up in turns
             with the eager step. Then `python3 -m pcf_torch.bench`'s line;
 13 entry    the user's entry points on the ScanNet-layout pipeline: synthetic
             rooms (tools/make_synth_dataset.py, 32 train + 4 val, 15,000
             points each) under pcf_torch/configs/synth_flagship.json
             (phase13_config: load_config with PERF.md section 4's overrides;
             PCF_Normal at the flagship width, bf16, windowed, pinned level
             caps); trainer.main for one epoch (8 steps), then again to two
             (it must resume from epoch 1), launch
             counts from 0 over each (A, B, C and D must launch), split into
             eager runs and captures; every eager kernel call of the first
             run (its first train step and its validation's first call)
             against its plain version at phases 4, 7 and 10's tolerances
             (replay_against_plain); the step graphs' captures, replays and
             pools; finite losses, metrics.jsonl, the checkpoint equal to
             main's final state bit for bit; the loader's host s per batch
             at NUM_WORKERS 0 and 4 and main's s/it from its third step on
             against the replay median of its step; one more epoch with
             unpinned caps (a graph per signature) under a pool budget of two
             train graphs: graphs dropped, and the card's memory reserved
             after it no more than the pools held and 1 GiB; then eval.simple.evaluate with fused_eval on the 4
             validation scenes from the checkpoint: E 29 times in each new
             signature's eager call (A to D never), each of those calls
             against its plain version, each replay against the eager
             forward (same_as_eager), its RMS distance from the f32
             standard forward against the eager standard bf16 forward's
             (FUSED_BF16_WITNESS), the fold on the trained weights in
             f32 at FOLD_TOL, replay ms and points/s per scene;
 14 pyramid  the device pyramid (data/post_knn.py) and voting on the card:
             pcf_torch/configs/post_knn_10cm.json (phase14_config: PCF_Normal
             at the flagship width, f32, BATCH_SIZE 16, pinned level caps),
             48 + 4 synthetic rooms (3-step epochs; phase 19 reads them
             too), while phase 15's exports run beside it in processes of
             their own. The loader's host s per batch for the host
             pyramid, post_knn and device_pyramid; one device_pyramid
             batch's pyramid built on the card (build_pyramid_packed, the
             post_knn loader's caps), each level's per-scene voxel counts
             equal to the host grid_subsampling's and its barycenters within
             PYRAMID_ATOL, no overflow, the kNN kernel launched 13 times;
             each of its 13 kNN calls (n_scenes BATCH_SIZE, as the main path
             makes them) captured and replayed (ms, valid pairs within
             scenes, bound), against the port's kNN on the CPU scene by
             scene for KNN_CPU_SCENES scenes (distances within KNN_DIST_REL
             of the scale, neighbour sets equal where not tied at k) and
             KNN_SAMPLED queries against float64, and the 13 through the
             plain version on the card; trainer.main under post_knn, then
             device_pyramid: B and C launched, A, D and E never, the kNN
             kernel 13 times in each preparation's eager run and 13 in its
             capture, none in a replay, every eager
             B and C call against its plain version, finite losses, the
             checkpoint equal to main's state, the prepare graph captured
             once and replayed for every later batch, main's s/it from its
             third step against the step's and the prepare's replay
             medians; B's and C's nei-mode calls of one eval forward timed
             beside their plain versions and bounds; eval.simple.evaluate
             under device_pyramid (replay ms per scene, scene 0's logits
             against the CPU at MODEL_TOL); eval.voting.evaluate_voting under
             device_pyramid, PYRAMID_VOTES rotations: every raw point voted,
             the wall, device+dispatch and host job times, captures per caps
             key; scene 0 at PYRAMID_CPU_VOTES rotation on the card against
             the CPU: probabilities within VOTE_ATOL.
 15 serve    the serving path (pcf_torch/serve) under phase 13's configuration
             (synth_flagship, bf16, windowed, B and C on every conv layer) with
             level caps pinned to 4 synthetic validation rooms of 15,000
             points (one bucket), the weights of phase 13's checkpoint (seeded,
             BN calibrated once, when the phase runs alone): `python -m
             pcf_torch.serve.export` as configured (--platforms cuda,cpu)
             and with fused_eval (cuda), two processes started after phase
             13, beside phase 14 (serve_start; seconds per program, the
             artifacts' files and sizes); the serving CLI `python -m
             pcf_torch.serve.predict` in a fresh process on the 4 rooms (a
             label file per room, its ms split into host, device, copy back
             and softmax; no pcf_torch.models, pcf_torch.nn, jax or pcf_tpu
             loaded); then per artifact in this process: load s, the first
             predict_packed (eager run and capture) with launch counts from 0
             over it, split into the eager run and the capture by a dispatch
             mode that sees the custom operators (A, B and C in the standard
             program; E once per conv layer, B and C never, in the fused one),
             every eager operator call against its kernel's plain version
             (replay_against_plain), predict_packed's replay against
             make_eval_step's on the same batch and weights (same_as_eager),
             both replays timed in turns and profiled; the standard program on
             the CPU and the card's on room 0, each against the f32 standard
             forward (bf16: the card's RMS error at most FUSED_BF16_WITNESS
             times the CPU's), and predict_scene per room (host, device, copy
             back, softmax ms; valid points/s).
 16 mesh     data-parallel training (parallel/mesh.py) on a mesh of one NCCL
             rank (a TCPStore on 127.0.0.1): on phase 3's batch, f32 and
             bf16, SyncBN on (cfg.bn_axis_name), make_eager_train_step and
             make_train_step over make_mesh() against mesh=None (its seed
             folded with rank 0): loss, metrics, every gradient, parameter
             and BN statistic equal bit for bit, for the eager body (launch
             counts from 0 over it: A, B, C, D), the captured first call and
             the replay; the eval steps' logits too; the all_reduce calls
             and bytes per step; replay ms with and without the mesh, in
             turns. Then trainer.main under multi_host in a torchrun-style
             group of one rank (RANK, WORLD_SIZE, MASTER_ADDR/PORT in the
             environment) on MESH_ROOMS synthetic rooms: it joins the group,
             launches A to D, logs as rank 0, and its checkpoint equals its
             state bit for bit;
 17 variants each off-default key (VARIANT_KEYS: transformer_type,
             attention_type, cm_geom, remat_layers, remat_deconv) flipped on
             PCF_Normal at the entry size (2 x 4000 points, windowed, K=16):
             launch counts from 0 over one f32 eval forward (A and C, and B
             where a PCFLayer runs), its logits against the CPU at MODEL_TOL;
             a captured SGD train step against its eager body (smooth
             kinks), the replay launching nothing eagerly; for the two remat
             keys the gradients against those without the key and each
             step's peak memory. PointConvFormer_Classification at the same
             width over the batch's two scenes as clouds: logits on the card
             against the CPU, two Adam train steps with finite losses.
 18 spatial  spatial sharding (parallel/spatial.py) on phase 3's batch with
             its windows unwrapped to plain edges, f32 and bf16: (a) on a
             mesh of one NCCL rank, the captured spatial eval step (launch
             counts from 0 over its first call: B and C, never A, D or E)
             against the unsharded forward on the same plain-edge batch,
             equal bit for bit or within GRAPH_REL; the captured spatial
             train step (SGD, every ReLU and max smooth) against mesh=None
             on it, first call and replay (spatial_held: f32 at phase 12's
             tolerances, bf16 by phase 8's witness against an f32 step),
             every eager B and C call of its first call against its plain
             version, its collectives and their bytes; the flagship step
             (AdamW) spatial, unsharded on plain edges and windowed, replays
             in turns, each first call's peak memory and graph pool, and the
             eval replays likewise; (b) the eager spatial eval and f32 train
             steps on SPATIAL_RANKS gloo ranks on cuda:0, each a process of
             this script (--spatial-rank), against (a)'s unsharded results;
             (c) trainer.main under spatial_train in a torchrun-style group
             of one NCCL rank on MESH_ROOMS rooms: 2 steps, B and C launched,
             A, D and E never, its checkpoint equal to its state.
 19 configs  the shipped configurations no earlier phase runs
             (CONFIG_NAMES: pcf_10cm, pcf_pallas_10cm, pcf_10cm_lite, pcf_5cm,
             pcf_2cm_ptf2), each from pcf_torch/configs/<name>.json at its own
             widths, BATCH_SIZE, caps, mix3D, accum_iter and drop_path_rate,
             through the trainer's CLI (trainer.cli with the argv `python -m`
             passes; --set only for the data and experiment paths and
             total_epoches=1, eval_freq=1, save_freq=1) on phase 14's rooms
             (2 steps; pcf_2cm_ptf2 5 micro-steps, one optimizer update; 2
             validation rooms), then eval.simple's CLI on its checkpoint:
             finite losses, the checkpoint equal to main's final state bit
             for bit, the optimizer's steps accum_iter implies, scene 0's
             logits on the card against the CPU port at MODEL_TOL, launch
             counts from 0 over each run that follow the switches (B and C
             for pcf_pallas_10cm, every eager call against its plain version;
             no port kernel for the others), the card's memory reserved
             after it within 1 GiB of before; CONFIG_MODULE_RUN once more
             through `python -m pcf_torch.train.trainer` in a process of its
             own; yaml never imported.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
The script needs a CUDA card and the repository beside it. `--profile` adds
a torch.profiler breakdown of one eval forward per dtype to phases 3 and 9
and of one train step per dtype to phase 6. `--resolve-baseline SOURCE`
adds to phase 4's window_resolve lines an earlier design of kernel A, built
from SOURCE (a window_resolve.cu with the C interface of commit fb3ad1e:
one thread per 16-, 8-, 4- or 2-byte chunk of an edge's row), held
bit-exact on every call and timed against this one in turns (old, new, new,
old), beside torch's zero_ of the same outputs (one launch each: the card's
write rate for the bytes the kernel writes).
"""

import contextlib
import dataclasses
import faulthandler
import functools
import gc
import glob
import json
import math
import re
import shutil
import statistics
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.nn import functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
# phase 3: calls a batch when timing the custom operators' dispatch
DISPATCH_CALLS = 200
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
# eval forwards timed per dtype, after warm-up (few: the whole script keeps
# to a time budget, PERF.md section 4)
FWD_WARMUP, FWD_REPS = 2, 5
# train steps timed per dtype, after warm-up (few, as FWD_REPS)
STEP_WARMUP, STEP_REPS = 2, 3
# window_scatter against its plain version: its f32 sums run in another
# order (1e-5 of the output's scale); in bf16 the f32 sums may round to
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
# a replay's logits against the eager forward's, of the logits' scale, where
# the two are not held bit for bit (phases 13 and 15, the entry points' own
# graphs; phase 12 holds its replays to eager exactly, B, C, D and E summing
# in a fixed order). f32: rounding of sums in another order moves a logit by
# under 4e-7 of the scale on the H100; bf16: such a difference may flip a
# bf16 rounding, one step of the largest logit (2^-7), held to four steps.
# Also the floor that a planted fault must move the logits past (phase 12's
# witnesses).
GRAPH_REL = {"float32": 1e-5, "bfloat16": 4 * 2 ** -7}
# phase 12: captured SGD train steps against eager ones, every ReLU and max
# smooth (phase 8's smooth_kinks: otherwise rounding alone moves a
# gradient across a kink): each loss relative, and the parameters within
# phase 8's gradient tolerance
GRAPH_LOSS_RTOL = 1e-6
# phase 12: the flagship's AdamW (capturable: the step count, the bias
# corrections and the LR are device tensors), every ReLU and max smooth. Its
# first full-rate step moves every weight by about the LR whatever its
# gradient's size, so an entry whose gradient is zero but for rounding steps
# either way, in two eager runs alike: the parameters of two runs are not
# comparable, nor, closely, their later losses. Each loss is held relative,
# beside the eager step's own spread; the state, which follows the gradient
# smoothly, is: `step` exactly; exp_avg and sqrt(exp_avg_sq) per parameter
# within phase 8's gradient tolerance or, where the eager step's own spread
# (a second eager run against the first, the same run) exceeds it, within
# ADAMW_STATE_WITNESS times that spread (three runs on the H100: eager
# against eager 0.97 to 1.28 of the tolerance, captured against eager 0.66
# to 1.01); and the last step's update of every
# entry against AdamW's formula on the state it left, the LR schedule(2) and
# step 3, within ADAMW_UPDATE_ATOL of that LR (f32 rounding of the weights is
# below 1e-4 of it). A counter frozen at 1 or the LR frozen at its capture
# value would read hundreds of times that (printed, and asserted beyond it)
ADAMW_LOSS_RTOL = 1e-3
ADAMW_STATE_WITNESS = 2.0
ADAMW_UPDATE_ATOL = 1e-3

SOURCES = {
    "window_resolve": ("pcf_torch/csrc/window_resolve.cu", "pcf_tpu/ops/window.py:369"),
    "pcf_conv_linear": ("pcf_torch/csrc/pcf_conv_linear.cu",
                        "pcf_tpu/ops/pallas/pconv_kernel.py:466"),
    "pconv_pe_conv_linear": ("pcf_torch/csrc/pcf_conv_linear.cu",
                             "pcf_tpu/ops/pallas/pconv_kernel.py:498"),
    "window_scatter": ("pcf_torch/csrc/window_scatter.cu", "pcf_tpu/ops/window.py:400"),
    "window_resolve_flat": ("pcf_torch/csrc/window_resolve.cu", "pcf_tpu/ops/window.py:545"),
    "fused_layer_eval": ("pcf_torch/csrc/layer_eval.cu", "pcf_tpu/attic/eval_kernel.py:325"),
    "knn_scene": ("pcf_torch/csrc/knn_scene.cu", "none (pcf_tpu/ops/knn.py is plain JAX)"),
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
        # detached: a train step's tables must not keep its graph alive
        self.calls.append(tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                for a in args))
        return self.fn(*args)

    def restore(self):
        setattr(self.module, self.name, self.fn)


class KwRecorder(Recorder):
    """A Recorder whose calls keep their keyword arguments: (args, kwargs)."""

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def snapshot(x):
    """A copy of a wrapper's argument: tensors cloned, also inside lists,
    tuples and dataclasses (WindowedEdges), everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        items = [snapshot(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: snapshot(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


class EagerRecorder(KwRecorder):
    """A KwRecorder for phase 13 that keeps a copy of the arguments of each
    call made outside a graph capture (a step's eager first call): the step
    goes on to write some of them in place (the weights, at the optimizer's
    update; the static batch, at each replay), and a capture's arguments
    hold no values."""

    def __call__(self, *args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            self.calls.append((snapshot(args), snapshot(kw)))
        return self.fn(*args, **kw)


def check_call(name, kern, plain, args, kw=None, label=None, rows=None) -> float:
    """One call of a kernel's wrapper `kern` against its plain version on
    the same inputs; returns the max abs error; with `rows` (a bool mask
    over the output's rows) on those rows alone. window_resolve bit-exact;
    B, C and E (pcf_conv_linear, pconv_pe_conv_linear, fused_layer_eval)
    within F32_TOL for float32 inputs, else within BF16_REL of the output's
    scale, E's max-pool shortcut exact; D (window_scatter) within
    SCATTER_F32_REL of the output's scale, and one bf16 step for a bf16
    output."""
    kw = kw or {}
    label = label or name
    got, want = kern(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if name == "window_resolve":
        assert torch.equal(got, want), f"{label}: not bit-exact"
        return 0.0
    if name == "fused_layer_eval":
        (got, got_s), (want, want_s) = got, want
        if want_s is not None:
            assert torch.equal(got_s, want_s), f"{label}: the shortcut differs"
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    if name == "window_scatter":
        tol = dict(rtol=0.0 if args[4] == torch.float32 else SCATTER_BF16_RTOL,
                   atol=SCATTER_F32_REL * scale)
    elif args[0].dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = dict(atol=BF16_REL * scale, rtol=BF16_REL)
    assert torch.allclose(got, want, **tol), (
        f"{label}: max err {diff:.3e} (scale {scale:.3e})")
    return diff


def replay_against_plain(recs, rows_of=None) -> dict:
    """Every call the EagerRecorders `recs` kept against its plain version
    (check_call), on the rows rows_of(name, index, args) gives (all rows
    where it gives None). Returns {wrapper name: (calls, max abs err)}."""
    from pcf_torch.ops.kernels.layer_eval import fused_layer_eval, fused_layer_eval_plain
    from pcf_torch.ops.kernels.pconv_fused import (
        pconv_pe_conv_linear, pconv_pe_conv_linear_plain, pcf_conv_linear,
        pcf_conv_linear_plain)
    from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_plain
    from pcf_torch.ops.kernels.window_scatter import window_scatter, window_scatter_plain

    pairs = {"window_resolve": (window_resolve, window_resolve_plain),
             "pcf_conv_linear": (pcf_conv_linear, pcf_conv_linear_plain),
             "pconv_pe_conv_linear": (pconv_pe_conv_linear, pconv_pe_conv_linear_plain),
             "window_scatter": (window_scatter, window_scatter_plain),
             "fused_layer_eval": (fused_layer_eval, fused_layer_eval_plain)}
    out = {}
    with torch.no_grad():
        for name, (kern, plain) in pairs.items():
            calls = [c for r in recs if r.name == name for c in r.calls]
            out[name] = (len(calls), max(
                (check_call(name, kern, plain, a, kw,
                            rows=None if rows_of is None else rows_of(name, i, a))
                 for i, (a, kw) in enumerate(calls)), default=0.0))
    return out


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


def conv_cost(kname, args) -> tuple[int, int]:
    """(bytes, operations) of one call of kernel B (pcf_conv_linear) or C
    (pconv_pe_conv_linear): table, indices, guidance or PE rows, weights and
    the linear read once, the f32 output written once; the contraction, the
    projection and B's guidance products."""
    from pcf_torch.ops.window import WindowedEdges

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
    """(model, loss, gradients as f64 CPU tensors) of one eager train step of
    the seed-1 model in `dtype` on `device`."""
    from pcf_torch.entry import build_training
    from pcf_torch.parallel.mesh import make_eager_train_step

    state, _ = build_training(cfg, device=device, seed=1)
    state.model.to(dtype)
    state, metrics = make_eager_train_step(cfg)(state, batch.to(device, dtype), 0)
    return state.model, metrics["loss"].item(), {
        k: p.grad.cpu().double() for k, p in state.model.named_parameters()}


def baseline_resolve(source: str):
    """fn(table, window_rows, localT) launching the window_resolve kernel
    built from `source` with the C interface of commit fb3ad1e:
    window_resolve(table, window_rows, localT, out, long long n_edges,
    int mtk, int wsz, int n_rows, int row_bytes, int chunk_bytes, stream)."""
    import ctypes
    import hashlib

    from pcf_torch.ops.kernels import build

    text = open(source, "rb").read()
    so = build.BUILD_DIR / f"window_resolve_baseline-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), source],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_resolve.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
    lib.window_resolve.restype = i

    def resolve(table, wr, lt):
        T, wsz = wr.shape
        mtk = lt.shape[-1]
        out = torch.empty((T, mtk, table.shape[1]), dtype=table.dtype, device=table.device)
        row_bytes = table.shape[1] * table.element_size()
        chunk = next(c for c in (16, 8, 4, 2) if row_bytes % c == 0
                     and table.data_ptr() % c == 0 and out.data_ptr() % c == 0)
        err = lib.window_resolve(table.data_ptr(), wr.data_ptr(), lt.data_ptr(),
                                 out.data_ptr(), T * mtk, mtk, wsz, table.shape[0],
                                 row_bytes, chunk, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline window_resolve failed with CUDA error {err}")
        return out

    return resolve


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
        elif (name == "_FusedConvLinearBackward" and node.needs_input_grad[2]
              and isinstance(node.edges, windowed_edges_cls)):
            n += 1
        stack.extend(f for f, _ in node.next_functions)
    return n


# the hand-written kernels as a profiler names them (each source keeps its
# kernels in an anonymous namespace), demangled or not
_SYMBOL = re.compile(r"(?:\(anonymous namespace\)::|_GLOBAL__N_1\d+)(resolve_wide|"
                     r"resolve_narrow|conv_linear_kernel|rows_kernel|layer_eval_kernel)")


def symbol_wrapper(name: str):
    """The wrapper whose kernel a profiler's kernel name is, or None: kernel
    A's two routes (window_resolve and window_resolve_flat both launch
    them), B and C (conv_linear_kernel's last template argument: PE), D's
    row pass (rows_kernel, one launch per call), E."""
    m = _SYMBOL.search(name)
    if m is None:
        return None
    sym = m.group(1)
    if sym.startswith("resolve_"):
        return "window_resolve"
    if sym == "rows_kernel":
        return "window_scatter"
    if sym == "layer_eval_kernel":
        return "fused_layer_eval"
    args = re.search(r"conv_linear_kernel<([^>]*)>", name)
    pe = (args.group(1).split(",")[-1].strip() in ("true", "1", "(bool)1") if args
          else re.findall(r"Lb([01])E", name)[-1] == "1")
    return "pconv_pe_conv_linear" if pe else "pcf_conv_linear"


def graph_expected(launches: dict) -> dict:
    """The kernels a replay must show, by wrapper, from an eager run's
    launch counts (the flat resolve launches kernel A's kernels)."""
    want = dict(launches)
    want["window_resolve"] = want.get("window_resolve", 0) + want.pop("window_resolve_flat", 0)
    return {k: n for k, n in want.items() if n}


def replay_profile(fn):
    """(hand-written kernels by wrapper, device busy ms, wall ms, device
    kernels) of one fn() under torch.profiler, the second of two profiled
    calls (the first pays the profiler's start-up)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    counts = {}
    for e in dev:
        w = symbol_wrapper(e.key)
        if w is not None:
            counts[w] = counts.get(w, 0) + e.count
    return (counts, sum(e.self_device_time_total for e in dev) / 1e3, wall,
            sum(e.count for e in dev))


def max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rms_diff(a, b) -> float:
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


def same_as_eager(label, got, want, again, dtype_name, exact=False):
    """A replay's logits against the eager forward's on the same batch:
    equal bit for bit with `exact` (and the two eager forwards too), else
    within GRAPH_REL of the scale for the model's compute dtype; `again`, a
    second eager forward, gives the eager forward's own spread."""
    scale = want.float().abs().max().item()
    d, spread = max_diff(got, want), max_diff(again, want)
    log(f"[graphs] {label}: replay against eager max abs err {d:.3e}; eager against eager "
        f"{spread:.3e} (logit scale {scale:.3e})")
    if exact:
        assert torch.equal(again, want), f"{label}: two eager forwards differ by {spread:.3e}"
        assert torch.equal(got, want), (
            f"{label}: the replay differs from the eager forward by {d:.3e}")
    assert d <= GRAPH_REL[dtype_name] * scale, (
        f"{label}: the replay differs from the eager forward by {d:.3e}")


def shared_calls(fn, calls):
    """window_scatter's calls as the train step's backward makes them,
    inside shared_inverses (one inverse per edge set)."""
    from pcf_torch.ops.kernels.window_scatter import shared_inverses

    with shared_inverses():
        return [fn(*a) for a in calls]


def unstable_calls(model, batch) -> tuple[str, int]:
    """Which calls of kernels B, C and E in one eager forward of `model` give
    outputs that differ bit for bit between two launches on the same
    inputs, by their channel ranges (blocks whose partial outputs meet in a
    workspace), and how many in all."""
    import pcf_torch.nn.fused as fused_mod
    import pcf_torch.nn.fused_eval as fused_eval_mod
    from pcf_torch.ops.kernels.layer_eval import launch_shape as layer_eval_shape
    from pcf_torch.ops.kernels.pconv_fused import launch_shape

    recs = [KwRecorder(fused_mod, "pcf_conv_linear"),
            KwRecorder(fused_mod, "pconv_pe_conv_linear"),
            KwRecorder(fused_eval_mod, "fused_layer_eval")]
    with torch.no_grad():
        model.eval()
        model.forward_batch(batch)
        for r in recs:
            r.restore()
        parts, total = [], 0
        for r in recs:
            splits = {}
            for a, kw in r.calls:
                if r.name == "fused_layer_eval":
                    sh, one, two = (layer_eval_shape(*a, **kw), r.fn(*a, **kw)[0],
                                    r.fn(*a, **kw)[0])
                else:
                    M, K, W = a[3].shape
                    sh = launch_shape(a[0].shape[1], K, W, a[4].shape[1], M,
                                      bf16=a[0].dtype == torch.bfloat16,
                                      P=a[2].shape[-1] if r.name == "pconv_pe_conv_linear" else 0)
                    one, two = r.fn(*a, **kw), r.fn(*a, **kw)
                n, bad = splits.get(sh["c_splits"], (0, 0))
                splits[sh["c_splits"]] = (n + 1, bad + (not torch.equal(one, two)))
            if r.calls:
                parts.append(f"{r.name} " + ", ".join(
                    f"{bad} of {n} calls with {c} channel range(s)"
                    for c, (n, bad) in sorted(splits.items())))
                total += sum(bad for _, bad in splits.values())
    return "; ".join(parts), total


def adamw_state(tx) -> dict:
    """Each parameter's AdamW state by position: step, exp_avg and
    sqrt(exp_avg_sq), detached copies."""
    out = {}
    for i, p in enumerate(tx.params):
        st = tx.inner.state[p]
        out[i] = (st["step"].detach().clone(), st["exp_avg"].detach().clone(),
                  st["exp_avg_sq"].detach().sqrt())
    return out


def adamw_update_error(tx, before, lr, step) -> float:
    """max over entries of |p - AdamW(p_before)| / (ADAMW_UPDATE_ATOL * lr):
    the last update of tx's parameters against torch's fused AdamW formula
    on the state it left (exp_avg, exp_avg_sq), the LR `lr` and step
    `step`."""
    (b1, b2), eps = tx.inner.defaults["betas"], tx.inner.defaults["eps"]
    bc1, bc2 = 1 - b1 ** step, math.sqrt(1 - b2 ** step)
    worst = 0.0
    for p, p0 in zip(tx.params, before):
        st = tx.inner.state[p]
        want = p0 * (1 - lr * tx.decay) - (lr / bc1) * st["exp_avg"] / (
            st["exp_avg_sq"].sqrt() / bc2 + eps)
        worst = max(worst, (p.detach() - want).abs().max().item())
    return worst / (ADAMW_UPDATE_ATOL * lr)


def graphs_phase(cfg, batch, batch2, models, eager_launches, valid):
    """Phase 12: the captured eval and train steps on the flagship batch
    (see the module docstring)."""
    from pcf_torch.entry import build, build_training
    from pcf_torch.parallel.mesh import (make_eager_eval_step, make_eager_train_step,
                                         make_eval_step, step_seed)

    eager_eval = make_eager_eval_step(cfg)
    eval_steps = {d: make_eval_step(cfg) for d in models}
    for path, dtype_name in (("standard", "float32"), ("standard", "bfloat16"),
                             ("fused_eval", "float32"), ("fused_eval", "bfloat16"),
                             ("flat_geom", "float32")):
        model, step = models[dtype_name], eval_steps[dtype_name]
        label = f"{path} {dtype_name}"
        model.cfg.update(fused_eval=path == "fused_eval", flat_geom=path == "flat_geom")
        graphs = step.graphs
        if path != "flat_geom":
            text, unstable = unstable_calls(model, batch)
            log(f"[graphs] {label}: launches not bit-stable run to run: {text}")
            assert unstable == 0, f"{label}: {unstable} kernel calls not bit-stable"
        want, again = eager_eval(model, batch), eager_eval(model, batch)
        captures = graphs.captures
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(model, batch)  # the eager run and the capture
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        same_as_eager(f"{label} first batch", step(model, batch), want, again, dtype_name,
                      exact=True)
        assert graphs.captures == captures + 1, f"{label}: {graphs.captures - captures} captures"
        same_as_eager(f"{label} second batch", step(model, batch2), eager_eval(model, batch2),
                      eager_eval(model, batch2), dtype_name, exact=True)
        assert graphs.captures == captures + 1, f"{label}: the second batch was captured anew"
        counts, busy, wall, n_kernels = replay_profile(lambda: step(model, batch))
        expected = graph_expected(eager_launches[(path, dtype_name)])
        log(f"[graphs] {label}: one profiled replay: hand-written kernels {counts} (the eager "
            f"forward launched {expected}); {n_kernels} device kernels, device busy "
            f"{busy:.3f} ms of {wall:.3f} ms ({busy / wall:.1%})")
        assert counts == expected, f"{label}: the replay's kernels {counts} != {expected}"
        times = timed_in_turns({"replay": lambda: step(model, batch),
                                "eager": lambda: eager_eval(model, batch)}, FWD_WARMUP, FWD_REPS)
        entry = list(graphs.entries.values())[-1]
        log(f"[graphs] {label}: forward ms, {FWD_REPS} reps after {FWD_WARMUP} warm-up in "
            f"turns: {turns_summary(times, valid)}; first call (eager run and capture) "
            f"{first_ms:.1f} ms, of which the capture {entry.capture_ms:.1f} ms; pool "
            f"{entry.pool_bytes / 2**20:.1f} MiB, {entry.live_bytes / 2**20:.1f} MiB live")
        if path == "fused_eval":
            # a train-mode forward moves the BN running statistics in place,
            # which the folds are made from: the graph is captured again
            before = eager_eval(model, batch)
            with torch.no_grad():
                model.train()
                model.forward_batch(batch2)
                model.eval()
            want, again = eager_eval(model, batch), eager_eval(model, batch)
            captures = graphs.captures
            step(model, batch)
            same_as_eager(f"{label} after a train-mode forward", step(model, batch), want,
                          again, dtype_name, exact=True)
            assert graphs.captures == captures + 1, f"{label}: not captured again"
            witness = max_diff(before, want)
            log(f"[graphs] {label}: the statistics before that forward would be off by "
                f"{witness:.3e}")
            if dtype_name == "float32":
                assert witness > GRAPH_REL[dtype_name] * want.float().abs().max().item(), (
                    f"{label}: the train-mode forward moved the logits by only {witness:.3e}")
    for model in models.values():
        model.cfg.update(fused_eval=False, flat_geom=False)
    del want, again

    # the train graph: 3 captured steps against 3 eager ones on copies of one
    # set of weights (build's seed), f32, beside a second eager copy (the
    # eager step's own spread): SGD with every ReLU and max smooth, without
    # and with dropout and DropPath (the registered generator), and the
    # flagship's AdamW as it is
    for opt, rate in (("SGD", 0.0), ("SGD", 0.1), ("AdamW", 0.0)):
        cfg_t = cfg.copy()
        cfg_t.update(compute_dtype="float32", optimizer=opt, dropout_rate=rate,
                     drop_path_rate=rate)
        copies = [build_training(cfg_t.copy(), device="cuda", seed=0) for _ in range(3)]
        captured, eager_step = copies[0][1], make_eager_train_step(cfg_t)
        states = [state for state, _ in copies]
        losses = [[] for _ in states]
        with smooth_kinks():
            for i in range(3):
                if i == 2:  # the weights and LR the last update starts from
                    before = [[p.detach().clone() for p in st.tx.params] for st in states]
                    lr = states[0].tx.schedule(states[0].tx.count)
                for j, state in enumerate(states):
                    _, m = (captured if j == 0 else eager_step)(state, batch, step_seed(0, i))
                    losses[j].append(m["loss"].item())
        assert captured.graphs.captures == 1 and captured.graphs.replays == 2, (
            captured.graphs.captures, captured.graphs.replays)
        params = [{k: p.detach() for k, p in state.model.named_parameters()}
                  for state in states]

        def apart(a, b):
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b]))
            return (rel,) + grad_ratios(params[a], params[b])

        (rel, over, worst, worst_key), (rel_e, over_e, worst_e, _) = apart(0, 1), apart(2, 1)
        log(f"[graphs] train f32 {opt} smooth, dropout and "
            f"DropPath {rate}: losses captured {[round(v, 7) for v in losses[0]]}, eager "
            f"{[round(v, 7) for v in losses[1]]} (max rel {rel:.2e}), eager again max rel "
            f"{rel_e:.2e}; parameters after 3 steps against the eager step's: captured worst "
            f"{worst_key} at {worst:.3f} of phase 8's tolerance, {over} beyond it; eager again "
            f"worst at {worst_e:.3f}, {over_e} beyond it")
        if opt == "SGD":
            assert rel <= GRAPH_LOSS_RTOL, f"captured train-step loss differs: {rel:.3e}"
            assert over == 0, f"parameter {worst_key} differs after 3 captured steps"
        else:
            assert rel <= ADAMW_LOSS_RTOL, f"captured AdamW train-step loss differs: {rel:.3e}"
            adam = [adamw_state(st.tx) for st in states]
            for j in (0, 1, 2):
                assert all(torch.equal(t[0], torch.full_like(t[0], 3.0))
                           for t in adam[j].values()), "an AdamW step count is not 3"
            reads = {}
            for part, name in ((1, "exp_avg"), (2, "sqrt(exp_avg_sq)")):
                pair = [{k: v[part] for k, v in adam[j].items()} for j in (0, 1, 2)]
                reads[name] = (grad_ratios(pair[0], pair[1]), grad_ratios(pair[2], pair[1]))
            update = {j: adamw_update_error(states[j].tx, before[j], lr, 3) for j in (0, 1)}
            faults = {"step frozen at 1": adamw_update_error(states[0].tx, before[0], lr, 1),
                      "LR frozen at capture": adamw_update_error(
                          states[0].tx, before[0], states[0].tx.schedule(0), 3)}
            log(f"[graphs] train f32 AdamW: step 3 in every state; " + "; ".join(
                f"{k} captured worst at {c[1]:.3f} of phase 8's tolerance ({c[2]}), {c[0]} "
                f"beyond it, eager again worst {e[1]:.3f}, {e[0]} beyond it"
                for k, (c, e) in reads.items()) +
                f"; last update against AdamW's formula (LR {lr:.6g}, step 3): captured "
                f"{update[0]:.4f}, eager {update[1]:.4f} of ADAMW_UPDATE_ATOL; planted "
                f"faults would read " + ", ".join(f"{k} {v:.1f}" for k, v in faults.items()))
            for k, (c, e) in reads.items():
                assert c[1] <= max(1.0, ADAMW_STATE_WITNESS * e[1]), (
                    f"captured AdamW {k} of {c[2]} differs from eager: {c[1]:.3f} of phase "
                    f"8's tolerance, the eager step's own spread {e[1]:.3f}")
            assert max(update.values()) <= 1.0, f"the last AdamW update is off: {update}"
            assert min(faults.values()) > 1.0, f"a planted fault passes the check: {faults}"
        del copies, states, captured, eager_step, params
        gc.collect()  # dropped graphs keep their pools until cyclic garbage goes

    # the derived weights follow replays: a model trained by the captured
    # step (SGD), its derived weights last made between its eager first step
    # and two replays, against a fresh model loaded with the trained weights
    # (and, as a witness, with the weights those derived weights were made
    # from): f32 through fused_eval (the BN folds), bf16 through the
    # standard forward (L's bf16 copies, each also held to the rounding of
    # the trained weight, bit for bit)
    for dtype_name, path in (("float32", "fused_eval"), ("bfloat16", "standard")):
        cfg_c = cfg.copy()
        cfg_c.update(compute_dtype=dtype_name, optimizer="SGD",
                     fused_eval=path == "fused_eval")
        state, captured = build_training(cfg_c, device="cuda", seed=0)
        model, step = state.model, make_eval_step(cfg_c)
        captured(state, batch, step_seed(1, 0))
        step(model, batch)
        stale = {k: v.clone() for k, v in model.state_dict().items()}
        for i in (1, 2):
            captured(state, batch, step_seed(1, i))
        assert captured.graphs.replays == 2, captured.graphs.replays
        fresh = build(cfg_c.copy(), device="cuda", seed=1)
        fresh.load_state_dict(model.state_dict())
        want, again = eager_eval(fresh, batch), eager_eval(fresh, batch)
        for k in ("recaptured", "replayed"):
            same_as_eager(f"{path} {dtype_name} after 2 train replays, {k}",
                          step(model, batch), want, again, dtype_name, exact=True)
        fresh.load_state_dict(stale)
        witness = max_diff(eager_eval(fresh, batch), want)
        log(f"[graphs] {path} {dtype_name}: the weights before the replays would be off by "
            f"{witness:.3e}")
        assert witness > GRAPH_REL[dtype_name] * want.float().abs().max().item(), (
            f"{path} {dtype_name}: the replays moved the logits by only {witness:.3e}")
        if dtype_name == "bfloat16":
            n = 0
            for mod in model.modules():
                hit = getattr(mod, "weight", None) is not None and \
                    mod.weight.__dict__.get("_pcf_bf16")
                if hit:
                    lw = mod.weight
                    assert torch.equal(hit[1][:, :lw.shape[1]], lw.detach().bfloat16()), (
                        "a bf16 copy of L does not follow the train replays")
                    n += 1
            assert n > 0, "no bf16 copy of L was made"
            log(f"[graphs] bfloat16: {n} bf16 copies of L equal the trained weights' rounding")
            from pcf_torch.ops.kernels.pconv_fused import _bf16_weight

            lws = [mod.weight for mod in model.modules()
                   if getattr(mod, "weight", None) is not None
                   and "_pcf_bf16" in mod.weight.__dict__]
            cast_ms = cuda_ms(lambda: [_bf16_weight(lw, False) for lw in lws])
            log(f"[graphs] bfloat16: rounding every L afresh instead of keeping its copy "
                f"would take {cast_ms:.4f} ms of device time per forward ({len(lws)} casts)")
        del state, captured, model, step, fresh, stale, want, again
        gc.collect()

    # the train graphs' kernels and times, f32 and bf16: a captured and an
    # eager step on two models, in turns
    for dtype_name in ("float32", "bfloat16"):
        cfg_d = cfg.copy()
        cfg_d.compute_dtype = dtype_name
        (sa, captured), (sb, _) = (build_training(cfg_d, device="cuda", seed=0),
                                   build_training(cfg_d.copy(), device="cuda", seed=0))
        eager_step = make_eager_train_step(cfg_d)
        seeds = iter(range(10 ** 6))
        torch.cuda.synchronize()
        t = time.perf_counter()
        captured(sa, batch, next(seeds))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        counts, busy, wall, n_kernels = replay_profile(lambda: captured(sa, batch, next(seeds)))
        expected = graph_expected(eager_launches[("train", dtype_name)])
        log(f"[graphs] train {dtype_name}: one profiled replay: hand-written kernels {counts} "
            f"(the eager step launched {expected}); {n_kernels} device kernels, device busy "
            f"{busy:.3f} ms of {wall:.3f} ms ({busy / wall:.1%})")
        assert counts == expected, f"train {dtype_name}: the replay's kernels {counts}"
        times = timed_in_turns({"replay": lambda: captured(sa, batch, next(seeds)),
                                "eager": lambda: eager_step(sb, batch, next(seeds))},
                               STEP_WARMUP, STEP_REPS)
        entry = list(captured.graphs.entries.values())[-1]
        log(f"[graphs] train {dtype_name}: step ms, {STEP_REPS} steps after {STEP_WARMUP} "
            f"warm-up in turns: {turns_summary(times, valid)}; first call (eager step and "
            f"capture) {first_ms:.1f} ms, of which the capture {entry.capture_ms:.1f} ms; "
            f"pool {entry.pool_bytes / 2**20:.1f} MiB, {entry.live_bytes / 2**20:.1f} MiB live")
        del sa, sb, captured, eager_step
        gc.collect()


def bench_phase():
    """Phase 12's bench: pcf_torch.bench's model, batch and captured eval
    step (bf16; the contraction in ops/pconv.py, kernel A resolving the
    feature tables), checked before bench.run times it: the launch counts of
    one eager forward, counted from 0 (kernel A, and nothing else, must
    launch); each of its window_resolve calls replayed bit-exact against its
    plain version; the first call (eager run and capture) and a replay
    against the eager forward (same_as_eager); the replay's hand-written
    kernels by symbol, as many as the eager forward launched."""
    import pcf_torch.ops.window as window_mod
    from pcf_torch import bench
    from pcf_torch.ops.kernels.layer_eval import fused_layer_eval
    from pcf_torch.ops.kernels.pconv_fused import pconv_pe_conv_linear, pcf_conv_linear
    from pcf_torch.ops.kernels.window_resolve import (window_resolve, window_resolve_flat,
                                                      window_resolve_plain)
    from pcf_torch.ops.kernels.window_scatter import window_scatter
    from pcf_torch.parallel.mesh import make_eager_eval_step

    model, step, batch = bench.workload()
    eager = make_eager_eval_step(model.cfg)
    wrappers = {"window_resolve": window_resolve, "pcf_conv_linear": pcf_conv_linear,
                "pconv_pe_conv_linear": pconv_pe_conv_linear,
                "window_scatter": window_scatter, "window_resolve_flat": window_resolve_flat,
                "fused_layer_eval": fused_layer_eval}
    rec = Recorder(window_mod, "window_resolve")
    for fn in wrappers.values():
        fn.launches = 0
    want = eager(model, batch)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    rec.restore()
    log(f"[bench] launches in one eager forward of the bench's model: {launches}")
    assert launches["window_resolve"] == len(rec.calls) > 0, launches
    assert sum(launches.values()) == launches["window_resolve"], launches
    assert want.shape == (batch.points[0].shape[0], model.cfg.num_classes), want.shape
    assert torch.isfinite(want[batch.masks[0]]).all(), "non-finite bench logits"
    with torch.no_grad():
        for args in rec.calls:
            assert torch.equal(window_resolve(*args), window_resolve_plain(*args)), (
                f"bench window_resolve differs from its plain version at table "
                f"{tuple(args[0].shape)} {args[0].dtype}")
    log(f"[bench] {len(rec.calls)} window_resolve calls bit-exact against the plain "
        f"version, tables {sorted({(a[0].shape[1], str(a[0].dtype)) for a in rec.calls})}")
    del rec
    again = eager(model, batch)
    same_as_eager("bench first call (eager run and capture)", step(model, batch), want,
                  again, "bfloat16")
    same_as_eager("bench replay", step(model, batch), want, again, "bfloat16")
    assert step.graphs.captures == 1 and step.graphs.replays == 1, (
        step.graphs.captures, step.graphs.replays)
    counts, busy, wall, n_kernels = replay_profile(lambda: step(model, batch))
    expected = graph_expected(launches)
    log(f"[bench] one profiled replay: hand-written kernels {counts} (the eager forward "
        f"launched {expected}); {n_kernels} device kernels, device busy {busy:.3f} ms of "
        f"{wall:.3f} ms ({busy / wall:.1%})")
    assert counts == expected, f"bench: the replay's kernels {counts} != {expected}"
    captures = step.graphs.captures
    bench.run(model, step, batch)
    assert step.graphs.captures == captures, "the bench captured its step anew"


def shipped_config(name: str) -> str:
    """The path of the port's copy of a shipped configuration (JSON, read
    without yaml: the card's machine has none)."""
    return os.path.join(HERE, "pcf_torch", "configs", f"{name}.json")


def data_overrides(data_dir: str, exp_dir: str) -> list:
    """--set overrides that put a run's data and experiment under a
    directory of its own: tools/make_synth_dataset.py's layout."""
    return [f"train_data_path={data_dir}/train/*.npz", f"val_data_path={data_dir}/val/*.npz",
            f"test_data_path={data_dir}/val/*.npz", f"experiment_dir={exp_dir}"]


def synth_rooms(out: str, train: int, val: int, points: int = 15000) -> float:
    """tools/make_synth_dataset.py's rooms (out/train, out/val); returns the
    seconds it took."""
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(HERE, "tools", "make_synth_dataset.py"),
                    "--out", out, "--train", str(train), "--val", str(val),
                    "--points", str(points)], check=True, capture_output=True)
    return time.time() - t0


# tools/make_synth_dataset.py's classes (synth_flagship.json's), labels 0-7
SYNTH_CLASSES = ["wall", "floor", "ceiling", "table", "chair", "sofa", "cabinet", "clutter"]
# phase 13's rooms: tools/make_synth_dataset.py at its default 15,000 points a
# room; 32 training rooms make an 8-step epoch at BATCH_SIZE 4, enough that
# the batches packed ahead while the first step captures its graph (the
# loader's prefetch queue) run out before the last steps
ENTRY_TRAIN_ROOMS, ENTRY_VAL_ROOMS, ENTRY_ROOM_POINTS = 32, 4, 15000
# phase 13: main's s/it is timed from this step on (0-based: the first is
# the eager run and the capture, the second may read a batch packed ahead)
ENTRY_STEADY_FROM = 2
# phase 13: train replays timed after warm-up, for main's s/it
ENTRY_REPLAY_WARMUP, ENTRY_REPLAY_REPS = 2, 5
# phase 13: evaluate's fused_eval replay (bf16) held, beside the eager
# standard bf16 forward, to the f32 standard forward of the same weights:
# its RMS error over the valid logits at most FUSED_BF16_WITNESS times the
# standard bf16 forward's. The two bf16 forwards round at other places (the
# folded weights, each layer's output), so their distance from each other
# grows with the activations: on the H100 it read 0.7e-2 to 1.1e-2 of the
# logit scale after 6 training steps (logits near 2) and 2.1e-2 to 3.3e-2
# after 32 (logits of 40-190). Against f32, the largest error of the fused
# replay read 0.80 to 1.48 times the standard forward's over 4 scenes; the
# RMS, the gate, averages out which logit happens to round worst. The
# ratio spreads with each run's trained weights
# (tools/torch_fused_bf16_spread.py): with E rounding its MLPs, scores and
# products to bf16, as pcf_tpu's kernel does, it read up to 2.49 in full
# runs; over 12 scenes of 3 runs, 0.53-1.75 for that rounding and 0.35-1.23
# for E as it is (PERF.md). A layer gone wrong moves the logits by their
# whole scale; each E call of the evaluation is also held to its plain
# version.
FUSED_BF16_WITNESS = 2.0


def phase13_config(data_dir: str, exp_dir: str):
    """Phase 13's configuration: pcf_torch/configs/synth_flagship.json as
    load_config reads it, with these overrides (PERF.md section 4): the fused
    conv kernels B and C on every conv layer, as phases 3-12 run them; the
    data and the experiment under the phase's temporary directory; one
    epoch; validation and a checkpoint every epoch."""
    from pcf_torch.config import load_config

    return load_config(shipped_config("synth_flagship"), [
        "USE_PALLAS_KERNEL=true", "fused_min_points=0", "resolve_impl=pallas",
        *data_overrides(data_dir, exp_dir), "total_epoches=1", "eval_freq=1", "save_freq=1"])


class EntryRecorder:
    """Phase 13's view into the entry points, which make their own steps:
    parallel.mesh.make_train_step and make_eval_step are wrapped so that each
    step function made records its calls (batch, start, duration, launches
    per wrapper and how many of them were inside a graph capture, and an eval
    call's logits); StepGraphs._capture is wrapped to count the launches made
    while a graph is captured; trainer.train_one_epoch to note when each
    epoch ended. Train calls are not synchronised (main's own timing); eval
    calls are, after the call (evaluate synchronises its timed call too)."""

    def __init__(self, wrappers):
        import pcf_torch.parallel.graphs as graphs_mod
        import pcf_torch.parallel.mesh as mesh_mod
        from pcf_torch.train import trainer

        self.wrappers = wrappers
        self.steps = {"train": [], "eval": []}
        self.epoch_ends = []
        self.in_capture = dict.fromkeys(wrappers, 0)
        self._undo = []
        capture, one_epoch = graphs_mod.StepGraphs._capture, trainer.train_one_epoch

        def counted_capture(graphs, *a, **kw):
            before = self.counts()
            try:
                return capture(graphs, *a, **kw)
            finally:
                for k, n in self.counts().items():
                    self.in_capture[k] += n - before[k]

        def timed_epoch(*a, **kw):
            out = one_epoch(*a, **kw)
            torch.cuda.synchronize()
            self.epoch_ends.append(time.perf_counter())
            return out

        self._patch(graphs_mod.StepGraphs, "_capture", counted_capture)
        self._patch(trainer, "train_one_epoch", timed_epoch)
        for kind in ("train", "eval"):
            make = getattr(mesh_mod, f"make_{kind}_step")
            self._patch(mesh_mod, f"make_{kind}_step", functools.partial(self._make, kind, make))

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)

    def counts(self) -> dict:
        return {k: fn.launches for k, fn in self.wrappers.items()}

    def zero(self):
        for fn in self.wrappers.values():
            fn.launches = 0
        self.in_capture = dict.fromkeys(self.wrappers, 0)

    def _make(self, kind, make, *a, **kw):
        step = make(*a, **kw)
        calls = []

        def recorded(*args):
            before, captured = self.counts(), dict(self.in_capture)
            t = time.perf_counter()
            out = step(*args)
            if kind == "eval":
                torch.cuda.synchronize()
            call = dict(batch=args[1], start=t, ms=(time.perf_counter() - t) * 1e3,
                        launches={k: n - before[k] for k, n in self.counts().items()},
                        captured={k: n - captured[k] for k, n in self.in_capture.items()})
            if kind == "eval":
                call.update(model=args[0], logits=out)
            calls.append(call)
            return out

        recorded.graphs, recorded.calls = step.graphs, calls
        self.steps[kind].append(recorded)
        return recorded


def eager_recorders() -> list:
    """EagerRecorders on every wrapper of kernels A-E where the model looks
    it up (the places of phases 4, 6 and 10)."""
    import pcf_torch.nn.fused as fused_mod
    import pcf_torch.nn.fused_eval as fused_eval_mod
    import pcf_torch.ops.kernels.pconv_fused as pconv_mod
    import pcf_torch.ops.kernels.window_resolve as resolve_mod
    import pcf_torch.ops.window as window_mod

    return [EagerRecorder(window_mod, "window_resolve"),
            EagerRecorder(pconv_mod, "window_resolve"),
            EagerRecorder(fused_mod, "pcf_conv_linear"),
            EagerRecorder(fused_mod, "pconv_pe_conv_linear"),
            EagerRecorder(resolve_mod, "window_scatter"),
            EagerRecorder(fused_eval_mod, "fused_layer_eval")]


KERNEL_LETTERS = {"window_resolve": "A", "pcf_conv_linear": "B", "pconv_pe_conv_linear": "C",
                  "window_scatter": "D", "window_resolve_flat": "flat", "fused_layer_eval": "E",
                  "knn_scene": "kNN"}


def launch_split(counts, captured) -> str:
    """Launches per kernel, split into eager ones and those inside captures."""
    return ", ".join(f"{KERNEL_LETTERS[k]} {n} ({n - captured[k]} eager, {captured[k]} in "
                     f"captures)" for k, n in counts.items())


def held_to_plain(tag, label, recs, counts, captured, rows_of=None):
    """The eager calls the EagerRecorders `recs` kept: one for each launch
    outside a capture, each against its plain version (check_call, on the
    rows of rows_of)."""
    for r in recs:
        r.restore()
    for k in ("window_resolve", "pcf_conv_linear", "pconv_pe_conv_linear",
              "window_scatter", "fused_layer_eval"):
        kept = sum(len(r.calls) for r in recs if r.name == k)
        assert kept == counts[k] - captured[k], (
            f"{label}: {kept} {k} calls kept, {counts[k] - captured[k]} launched eagerly")
    res = replay_against_plain(recs, rows_of)
    log(f"{tag} {label}: every eager kernel call against its plain version: " + "; ".join(
        f"{KERNEL_LETTERS[k]} {n} calls, " + ("bit-exact" if k == "window_resolve" else
                                              f"max abs err {e:.3e}")
        for k, (n, e) in res.items() if n))
    return res


def graph_pools(step) -> str:
    """A step function's graphs: held, pool, captures, replays, evictions."""
    from pcf_torch.utils.memory import graph_pool_bytes

    g = graph_pool_bytes(step.graphs)
    return (f"{g['graphs']} graph(s) held, pool {g['pool_bytes'] / 2**20:.1f} MiB "
            f"({g['live_bytes'] / 2**20:.1f} MiB live), captures {step.graphs.captures}, "
            f"replays {step.graphs.replays}, evictions {step.graphs.evictions}")


def entry_phase(wrappers, smi, device="cuda", keep_checkpoint=None):
    """Phase 13: trainer.main and eval.simple.evaluate on the card (see the
    module docstring); the entry points take their default device, the
    checks run on `device`. `keep_checkpoint`: a directory to copy main's
    checkpoints into (phase 15 serves them)."""
    import pcf_torch.parallel.graphs as graphs_mod
    from pcf_torch.data.pyramid import use_native
    from pcf_torch.data.scannet import getdataLoaders
    from pcf_torch.entry import build
    from pcf_torch.eval.simple import evaluate
    from pcf_torch.nn.layers import PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE
    from pcf_torch.parallel.mesh import make_eager_eval_step
    from pcf_torch.train import trainer
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.utils.memory import graph_pool_bytes

    split, pools = launch_split, graph_pools

    def eager_calls_held(label, recs, counts, captured):
        held_to_plain("[entry]", label, recs, counts, captured)

    def train_gates(label, cfg, rec, unpinned=False):
        counts, captured = rec.counts(), dict(rec.in_capture)
        log(f"[entry] {label}: launches {split(counts, captured)}")
        for k in ("window_resolve", "pcf_conv_linear", "pconv_pe_conv_linear", "window_scatter"):
            assert counts[k] > 0, f"{label}: {k} was not launched through trainer.main"
        train, val = rec.steps["train"][-1], rec.steps["eval"][-1]
        sigs = [c["batch"].signature() for c in train.calls]
        windowed = {s for s, c in zip(sigs, train.calls)
                    if not isinstance(c["batch"].edges_self[0], torch.Tensor)}
        log(f"[entry] {label}: {len(train.calls)} train steps of {len(set(sigs))} "
            f"signature(s) ({len(windowed)} windowed); train graphs: {pools(train)}; "
            f"validation graphs: {pools(val)}")
        g = train.graphs
        newest = max(e.pool_bytes for e in g.entries.values())
        budget = g.budget_bytes(device)
        assert g.pool_bytes() <= max(budget, newest), (
            f"{label}: pools of {g.pool_bytes()} bytes over the budget {budget}")
        if not unpinned:
            assert len(windowed) <= 1, f"{label}: pinned caps gave {len(windowed)} signatures"
            assert g.captures == len(set(sigs)) and g.evictions == 0, (
                f"{label}: {g.captures} captures, {g.evictions} evictions for "
                f"{len(set(sigs))} signatures")
        log(f"[entry] {label}: level caps {cfg.get('level_caps')}, window sizes "
            f"{cfg.window_sizes}")
        return train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as root:
        data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
        secs = synth_rooms(data, ENTRY_TRAIN_ROOMS, ENTRY_VAL_ROOMS, ENTRY_ROOM_POINTS)
        log(f"[entry] {ENTRY_TRAIN_ROOMS} + {ENTRY_VAL_ROOMS} synthetic rooms written in "
            f"{secs:.1f} s; host pyramid: "
            f"{'native (pcf_torch/native, built by g++)' if use_native() else 'numpy/scipy'}")
        rec = EntryRecorder(wrappers)
        try:
            # -- trainer.main: one epoch, then resumed to two ------------------
            s_per_it = []
            for total in (1, 2):
                label = f"trainer.main to epoch {total}"
                cfg = phase13_config(data, exp)
                cfg.total_epoches = total
                rec.zero()
                # the first run's eager calls (its first train step and its
                # validation's first call), each held to its plain version
                recs = eager_recorders() if total == 1 else []
                ends = len(rec.epoch_ends)
                t0 = time.perf_counter()
                state = trainer.main(cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                train = train_gates(label, cfg, rec)
                if recs:
                    eager_calls_held(label, recs, rec.counts(), rec.in_capture)
                    del recs
                    gc.collect()
                calls, end = train.calls, rec.epoch_ends[ends]
                assert len(calls) == ENTRY_TRAIN_ROOMS // cfg.BATCH_SIZE, (
                    f"{label}: {len(calls)} steps")
                steady = calls[ENTRY_STEADY_FROM:]
                s_it = (end - steady[0]["start"]) / len(steady)
                s_per_it.append(s_it)
                gaps = [b["start"] - a["start"] for a, b in zip(calls, calls[1:])]
                log(f"[entry] {label}: {wall:.1f} s in all; the epoch's first step (eager run and "
                    f"capture) {calls[0]['ms'] / 1e3:.3f} s; {s_it:.4f} s/it over steps "
                    f"{ENTRY_STEADY_FROM + 1}-{len(calls)}; s from each step's start to the "
                    f"next's {[round(g, 4) for g in gaps]}")
            logfile = open(os.path.join(exp, "log.txt")).read()
            assert "resumed from epoch 1" in logfile, "the second main did not resume"
            lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
            assert [sorted(k for k in r if k.startswith(("train_", "val_"))) for r in lines] == [
                ["train_allacc", "train_loss", "train_macc", "train_miou"],
                ["val_allacc", "val_macc", "val_miou"]] * 2, lines
            losses = [r["train_loss"] for r in lines if "train_loss" in r]
            assert all(math.isfinite(v) for v in losses), losses
            params, stats, epoch = CheckpointManager(os.path.join(exp, "model")).restore_eval()
            saved = {**params, **stats}
            for k, v in state.model.state_dict().items():
                assert torch.equal(v.cpu(), saved[k]), f"checkpoint differs from main's {k}"
            log(f"[entry] metrics.jsonl: {len(lines)} lines, train losses {losses}; checkpoint "
                f"of epoch {epoch} equal to main's final state bit for bit "
                f"({len(saved)} tensors)")

            # the same step, replayed on its last batch
            batch = train.calls[-1]["batch"]
            replays = []
            for i in range(ENTRY_REPLAY_WARMUP + ENTRY_REPLAY_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                train(state, batch, i)
                torch.cuda.synchronize()
                if i >= ENTRY_REPLAY_WARMUP:
                    replays.append(time.perf_counter() - t)
            replay_s = statistics.median(replays)

            # the loader alone: one epoch of train batches per worker count
            loader_s = {}
            for workers in (0, 4):
                cfg_l = phase13_config(data, exp)
                cfg_l.update(NUM_WORKERS=workers, level_caps=cfg.level_caps,
                             window_sizes=cfg.window_sizes)
                loader, _, _, _ = getdataLoaders(cfg_l)
                t = time.perf_counter()
                n = sum(1 for _ in loader)
                loader_s[workers] = ((time.perf_counter() - t) / n, n)
            log(f"[entry] loader: " + "; ".join(
                f"NUM_WORKERS {w}: {s:.4f} s per packed batch ({n} batches)"
                for w, (s, n) in loader_s.items()))
            train_pool = max(e.pool_bytes for e in train.graphs.entries.values())
            del state, train, batch
            for steps in rec.steps.values():
                steps.clear()  # their graphs and pools
            gc.collect()

            # -- one epoch under unpinned caps: a graph per signature, the
            # pools held to a budget of two train graphs, so that the least
            # recently used are dropped and their memory goes back ---------
            cfg_u = phase13_config(data, os.path.join(root, "exp_unpinned"))
            cfg_u.pin_level_caps = False
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            rec.zero()
            graphs_mod.POOL_BUDGET_BYTES = 2 * train_pool
            try:
                trainer.main(cfg_u)
                unpinned = train_gates("trainer.main, unpinned caps", cfg_u, rec,
                                       unpinned=True)
            finally:
                graphs_mod.POOL_BUDGET_BYTES = None
            g = unpinned.graphs
            sigs = {c["batch"].signature() for c in unpinned.calls}
            assert g.evictions > 0 or len(sigs) <= 2, (
                f"{len(sigs)} signatures under a budget of two train graphs, no eviction")
            gc.collect()
            torch.cuda.empty_cache()
            grown = torch.cuda.memory_reserved() - reserved
            held = g.pool_bytes() + rec.steps["eval"][-1].graphs.pool_bytes()
            log(f"[entry] trainer.main, unpinned caps, budget {2 * train_pool / 2**20:.1f} MiB "
                f"(two train graphs): memory reserved grew by {grown / 2**20:.1f} MiB, the "
                f"graphs held (train and validation) {held / 2**20:.1f} MiB")
            # besides the pools held: the model, its optimizer state, the
            # static batches; a dropped train graph's pool is 3.8-4.8 GiB
            assert grown <= held + 2**30, (
                f"the memory of dropped graphs did not come back: {grown} bytes reserved, "
                f"{held} held in pools")
            unpinned_pool = graph_pool_bytes(g)["pool_bytes"]
            del unpinned, g
            for steps in rec.steps.values():
                steps.clear()
            gc.collect()

            # -- eval.simple.evaluate with fused_eval, from the checkpoint -----
            cfg_e = phase13_config(data, exp)
            cfg_e.update(fused_eval=True, eval_path=os.path.join(root, "eval"))
            rec.zero()
            recs = eager_recorders()
            miou, mean_s = evaluate(cfg_e, pretrain_path=os.path.join(exp, "model"))
            counts, captured = rec.counts(), dict(rec.in_capture)
            log(f"[entry] evaluate: launches {split(counts, captured)}; mIoU {miou:.4f}, "
                f"{mean_s * 1e3:.3f} ms per scene (evaluate's own mean)")
            assert counts["fused_layer_eval"] > 0, "E was not launched through evaluate"
            for k in ("pcf_conv_linear", "pconv_pe_conv_linear", "window_scatter"):
                assert counts[k] == 0, f"evaluate with fused_eval launched {k}"
            eager_calls_held("evaluate", recs, counts, captured)
            del recs
            assert 0.0 <= miou <= 1.0 and math.isfinite(mean_s), (miou, mean_s)
            ev = rec.steps["eval"][-1]
            assert len(ev.calls) == 2 * ENTRY_VAL_ROOMS, len(ev.calls)
            model = ev.calls[0]["model"]
            conv_layers = (PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE)
            n_conv = sum(isinstance(m, conv_layers) for m in model.modules())
            cfg32 = cfg_e.copy()
            cfg32.compute_dtype = "float32"
            model32 = build(cfg32, device=device)
            model32.load_state_dict(model.state_dict())
            eager = make_eager_eval_step(cfg_e)
            outs = sorted(os.listdir(cfg_e.eval_path))
            seen = set()
            for i in range(ENTRY_VAL_ROOMS):
                first, second = ev.calls[2 * i], ev.calls[2 * i + 1]
                batch = first["batch"].to(device)
                sig = first["batch"].signature()
                e_first = first["launches"]["fused_layer_eval"] - first["captured"][
                    "fused_layer_eval"]
                if sig in seen:
                    assert sum(first["launches"].values()) == 0, first["launches"]
                else:
                    assert e_first == first["captured"]["fused_layer_eval"] == n_conv, (
                        f"scene {i}: E {e_first} times in the eager call, "
                        f"{first['captured']['fused_layer_eval']} in the capture, for "
                        f"{n_conv} conv layers")
                seen.add(sig)
                assert sum(second["launches"].values()) == 0, second["launches"]
                model.cfg.fused_eval = True
                want, again = eager(model, batch), eager(model, batch)
                same_as_eager(f"evaluate scene {i} replay", second["logits"], want, again,
                              "bfloat16")
                model.cfg.fused_eval = False
                standard = eager(model, batch)
                model.cfg.fused_eval = True
                m0 = batch.masks[0]
                with torch.no_grad():
                    model32.cfg.fused_eval = False
                    std32 = model32.forward_batch(batch)
                    model32.cfg.fused_eval = True
                    fused32 = model32.forward_batch(batch)
                fold = max_diff(fused32[m0], std32[m0])
                assert torch.allclose(fused32[m0], std32[m0], **FOLD_TOL), (
                    f"scene {i}: the fold of the trained weights differs by {fold:.3e}")
                want32 = std32[m0]
                scale = want32.abs().max().item()
                to_standard = max_diff(second["logits"][m0], standard[m0])
                fused_err, standard_err = (
                    (max_diff(x[m0], want32), rms_diff(x[m0], want32))
                    for x in (second["logits"], standard))
                ratio = fused_err[1] / standard_err[1]
                assert ratio <= FUSED_BF16_WITNESS, (
                    f"scene {i}: the bf16 fused_eval replay is {fused_err[1]:.3e} (RMS) from "
                    f"the f32 standard forward, the bf16 standard forward {standard_err[1]:.3e}")
                valid = int(m0.sum())
                log(f"[entry] evaluate scene {i}: {valid} valid points, caps "
                    f"{[p.shape[0] for p in batch.points]}, "
                    f"{'new signature' if e_first else 'signature seen before'}: first call "
                    f"{first['ms']:.1f} ms, replay {second['ms']:.3f} ms "
                    f"({valid / second['ms'] * 1e3:.1f} points/s); against the f32 standard "
                    f"forward (logit scale {scale:.3e}), max abs / RMS err: the bf16 replay "
                    f"{fused_err[0]:.3e} / {fused_err[1]:.3e}, the eager bf16 standard forward "
                    f"{standard_err[0]:.3e} / {standard_err[1]:.3e}, RMS ratio {ratio:.3f} "
                    f"(FUSED_BF16_WITNESS), max ratio {fused_err[0] / standard_err[0]:.3f}; the "
                    f"replay against the bf16 standard forward {to_standard:.3e} "
                    f"({to_standard / scale:.3e} of the scale); fold in f32 {fold:.3e} "
                    f"(FOLD_TOL)")
                for suffix in ("_probs.npy", ".ply", ".txt"):
                    assert any(f.endswith(suffix) for f in outs), f"no {suffix} written"
            log(f"[entry] evaluate graphs: {pools(ev)}")
            eval_pool = graph_pool_bytes(ev.graphs)["pool_bytes"]
        finally:
            rec.restore()
        if keep_checkpoint:
            shutil.copytree(os.path.join(exp, "model"), keep_checkpoint)
    log(f"[entry] summary ({smi}): loader host s per packed batch "
        + ", ".join(f"NUM_WORKERS {w} {s:.4f}" for w, (s, _) in loader_s.items())
        + f"; main (NUM_WORKERS {cfg.NUM_WORKERS}) s/it from step {ENTRY_STEADY_FROM + 1} on "
        f"{', '.join(f'{s:.4f}' for s in s_per_it)} (epochs 1, 2) against the train replay "
        f"median {replay_s:.4f} s ({len(replays)} replays, min {min(replays):.4f}, max "
        f"{max(replays):.4f}); graph pools: unpinned train epoch "
        f"{unpinned_pool / 2**20:.1f} MiB, evaluate {eval_pool / 2**20:.1f} MiB")


# phase 14's rooms: tools/make_synth_dataset.py at its 15,000 points a room;
# 48 training rooms make a 3-step epoch at BATCH_SIZE 16 (few: the time
# budget)
PYRAMID_TRAIN_ROOMS, PYRAMID_VAL_ROOMS = 48, 4
# phase 14: voting's rotations (pcf_tpu's default is 8; cut for time); the
# card against the CPU on scene 0 at PYRAMID_CPU_VOTES
PYRAMID_VOTES, PYRAMID_CPU_VOTES = 2, 1
# phase 14: the train and prepare replays timed after warm-up
PYRAMID_REPLAY_WARMUP, PYRAMID_REPLAY_REPS = 1, 2
# phase 14: the scenes of the checked batch whose kNN is run again on the CPU
# (every scene is also in the float64 sample)
KNN_CPU_SCENES = 4
# phase 14 kNN, card against CPU: distances within KNN_DIST_REL of the call's
# largest; a row's index set equal wherever its k-th and (k+1)-th distances
# differ by more than KNN_TIE_REL (relative); KNN_SAMPLED queries a call
# against a float64 brute force
KNN_DIST_REL, KNN_TIE_REL, KNN_SAMPLED = 1e-5, 1e-6, 1024
# phase 14: f32 operations of a valid (query, ref) pair in the kNN kernel's
# bound (three differences, three products, two sums)
KNN_OPS_PER_PAIR = 8
# phase 14: the device pyramid's barycenters against the host's, after
# sorting (tests/test_post_knn.py:146)
PYRAMID_ATOL = 1e-4
# phase 14: voting's probabilities, card against CPU (the port's tolerance
# against pcf_tpu in tests/test_torch_voting.py)
VOTE_ATOL = 1e-4


def phase14_config(data_dir: str, exp_dir: str):
    """Phase 14's configuration: pcf_torch/configs/post_knn_10cm.json as
    load_config reads it, with these overrides (PERF.md section 4): the
    fused conv kernels B and C on every conv layer; pinned level caps
    (synth_flagship's sample and margin), so that an epoch has one
    signature; the data, the experiment and the evaluation under the
    phase's temporary directory; one epoch, validated and saved; the
    synthetic rooms' 8 classes."""
    from pcf_torch.config import load_config

    return load_config(shipped_config("post_knn_10cm"), [
        "USE_PALLAS_KERNEL=true", "fused_min_points=0", "pin_level_caps=true",
        "level_caps_sample=8", "level_caps_margin=1.15", *data_overrides(data_dir, exp_dir),
        f"eval_path={exp_dir}/eval", "total_epoches=1", "eval_freq=1", "save_freq=1",
        "num_classes=8", f"classes={json.dumps(SYNTH_CLASSES)}"])


class PrepareRecorder:
    """Wraps data/post_knn.make_prepare where the entry points look it up:
    every prep made is kept, with each call's input batch (on the CPU, as
    the loader gives it), start and host ms."""

    def __init__(self):
        import pcf_torch.data.post_knn as post_knn_mod

        self.module, self.make = post_knn_mod, post_knn_mod.make_prepare
        self.preps = []
        post_knn_mod.make_prepare = self._make

    def _make(self, cfg):
        prep = self.make(cfg)
        calls = []

        def recorded(batch, device):
            t = time.perf_counter()
            out = prep(batch, device)
            calls.append(dict(batch=batch, start=t, ms=(time.perf_counter() - t) * 1e3))
            return out

        recorded.graphs, recorded.calls, recorded.cfg = prep.graphs, calls, cfg
        self.preps.append(recorded)
        return recorded

    def restore(self):
        self.module.make_prepare = self.make


def host_times(fn, warmup: int, reps: int) -> list:
    """Host seconds of fn() ended by a synchronize, `reps` runs after warm-up."""
    out = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append(time.perf_counter() - t)
    return out


def graph_ms(fn, reps=3):
    """(outputs of the last replay, device ms per replay): fn captured once
    into a CUDA graph (after an eager warm-up run) and replayed, timed as
    cuda_ms times; the graph is dropped after. cuBLAS's per-stream
    workspace is dropped around the capture, as parallel/graphs.py does, so
    that no later matmul takes the one this graph's pool held."""
    fn()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    ms = cuda_ms(g.replay, reps=reps, warmup=1)
    del g
    torch._C._cuda_clearCublasWorkspaces()
    return out, ms


def valid_rows(step_calls):
    """rows_of for held_to_plain: the valid output rows of each eager B and
    C call the EagerRecorders kept, from the masks of the batch of the step
    call that made it (the step calls in order; a call's level is the one
    with its row count, when only one level has it). The device pyramid
    pads its levels with points at 1e6, whose rows are masked everywhere
    and carry values up to about 1e7, where f32 sums in another order
    differ by more than F32_TOL."""
    owners = {k: [c["batch"] for c in step_calls
                  for _ in range(c["launches"].get(k, 0) - c["captured"].get(k, 0))]
              for k in ("pcf_conv_linear", "pconv_pe_conv_linear")}

    def rows_of(name, i, args):
        if name not in owners:
            return None
        masks = [m for m in owners[name][i].masks if m.shape[0] == args[3].shape[0]]
        return masks[0] if len(masks) == 1 else None

    return rows_of


def knn_calls(batch):
    """The 13 kNN calls of compute_knn_packed on `batch`, as (label, query
    level, ref level, k)."""
    n = len(batch.points)
    calls = []
    for lvl in range(n):
        calls.append((f"self {lvl}", lvl, lvl))
        if lvl < n - 1:
            calls.append((f"forward {lvl + 1}->{lvl}", lvl + 1, lvl))
            calls.append((f"propagate {lvl}->{lvl + 1}", lvl, lvl + 1))
    return calls


def knn_check(batch, k, rng, n_scenes):
    """Phase 14b: every kNN call of `batch` (on the card, as
    compute_knn_packed makes it: n_scenes scenes) in one CUDA graph each,
    replayed and timed, its result against the port's kNN on the CPU run
    scene by scene on the same points (the first KNN_CPU_SCENES scenes), and
    KNN_SAMPLED queries of every scene against a float64 brute force; the
    13 calls then timed once more through the plain version on the card.
    Returns (total replay ms, the plain version's ms, the valid pairs within
    scenes, the largest distance error against the CPU)."""
    from pcf_torch.ops.knn import knn, knn_plain

    tot_ms = tot_pairs = max_err = 0.0
    calls = []
    for label, ql, rl in knn_calls(batch):
        q, r = batch.points[ql], batch.points[rl]
        qb, rb, rm = batch.bids[ql], batch.bids[rl], batch.masks[rl]
        calls.append((q, r, dict(query_bid=qb, ref_bid=rb, ref_mask=rm)))
        with torch.no_grad():
            (idx, dist), ms = graph_ms(lambda: knn(q, r, k, query_bid=qb, ref_bid=rb,
                                                   ref_mask=rm, n_scenes=n_scenes,
                                                   return_dist=True))
        idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
        qm = batch.masks[ql].cpu().numpy()
        qbn, rbn, rmn = qb.cpu().numpy(), rb.cpu().numpy(), rm.cpu().numpy()
        qp, rp = q.cpu(), r.cpu()
        scenes = np.unique(qbn[qm])[:KNN_CPU_SCENES]
        scale = float(dist[qm].max())
        worst = checked = tied = 0
        for sc in scenes:
            rows = np.nonzero(qm & (qbn == sc))[0]
            refs = np.nonzero(rmn & (rbn == sc))[0]
            ci, cd = knn(qp[rows], rp[refs], k + 1, return_dist=True)
            ci, cd = refs[ci.numpy()], cd.numpy()
            worst = max(worst, float(np.abs(dist[rows] - cd[:, :k]).max()))
            distinct = cd[:, k] - cd[:, k - 1] > KNN_TIE_REL * np.maximum(cd[:, k], 1e-30)
            got, want = np.sort(idx[rows], 1), np.sort(ci[:, :k], 1)
            bad = np.nonzero(distinct & (got != want).any(1))[0]
            assert not len(bad), (f"[pyramid] kNN {label} scene {sc}: {len(bad)} rows with "
                                  f"another neighbour set, e.g. row {rows[bad[0]]}")
            checked += int(distinct.sum())
            tied += int((~distinct).sum())
        assert worst <= KNN_DIST_REL * scale, (
            f"[pyramid] kNN {label}: distances {worst:.3e} from the CPU's (scale {scale:.3e})")
        # float64 brute force on sampled valid queries, against their own
        # scene's valid refs (every other ref is invalid for them)
        sample = rng.choice(np.nonzero(qm)[0], size=min(KNN_SAMPLED, int(qm.sum())),
                            replace=False)
        qnp, rnp = qp.numpy().astype(np.float64), rp.numpy().astype(np.float64)
        f64_err, bad = 0.0, 0
        for sc in np.unique(qbn[sample]):
            rows = sample[qbn[sample] == sc]
            refs = np.nonzero(rmn & (rbn == sc))[0]
            d64 = ((qnp[rows][:, None, :] - rnp[refs][None, :, :]) ** 2).sum(-1)
            order = np.argsort(d64, 1)[:, :k + 1]
            part = np.take_along_axis(d64, order, 1)
            f64_err = max(f64_err, float(np.abs(dist[rows] - part[:, :k]).max()))
            distinct = part[:, k] - part[:, k - 1] > KNN_TIE_REL * part[:, k]
            bad += int((distinct & (np.sort(idx[rows], 1)
                                    != np.sort(refs[order[:, :k]], 1)).any(1)).sum())
        assert f64_err <= KNN_DIST_REL * scale, (
            f"[pyramid] kNN {label}: distances {f64_err:.3e} from float64 (scale {scale:.3e})")
        assert not bad, f"[pyramid] kNN {label}: {bad} sampled rows differ from float64"
        # the valid (query, ref) pairs within scenes: what the kernel scans
        in_range = (qbn >= 0) & (qbn < n_scenes)
        per_q = np.bincount(qbn[in_range], minlength=n_scenes)
        per_r = np.bincount(rbn[rmn & (rbn >= 0) & (rbn < n_scenes)], minlength=n_scenes)
        pairs = float((per_q * per_r).sum())
        bound = pairs * KNN_OPS_PER_PAIR / PEAK_OPS[torch.float32] * 1e3
        tot_ms, tot_pairs, max_err = tot_ms + ms, tot_pairs + pairs, max(max_err, worst)
        log(f"[pyramid] kNN {label}: M={q.shape[0]} N={r.shape[0]} k={k}, {pairs:.3e} valid "
            f"pairs within scenes, replay {ms:.3f} ms (bound {bound:.4f} ms); against the CPU "
            f"per scene: max distance err {worst:.3e} (scale {scale:.3e}), {checked} rows' "
            f"sets equal, {tied} rows tied at k; float64 on {len(sample)} queries: {f64_err:.3e}")
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: [knn_plain(q, r, k, **kw) for q, r, kw in calls],
                           reps=1, warmup=0)
    return tot_ms, plain_ms, tot_pairs, max_err


def pyramid_phase(wrappers, smi, device="cuda", rooms=None):
    """Phase 14: the device pyramid and voting on the card (see the module
    docstring); the entry points take their default device, the checks run
    on `device`. `rooms`: synth_rooms' PYRAMID_TRAIN_ROOMS +
    PYRAMID_VAL_ROOMS rooms, else made here. Returns the kNN kernel's row of
    the `kernels` line."""
    from pcf_torch.data import post_knn as post_knn_mod
    from pcf_torch.data.scannet import getdataLoaders
    from pcf_torch.entry import build
    from pcf_torch.eval.simple import evaluate
    from pcf_torch.eval.voting import evaluate_voting
    from pcf_torch.ops.subsample import grid_subsample_fixed, grid_subsampling
    from pcf_torch.train import trainer
    from pcf_torch.train.checkpoint import CheckpointManager
    from scipy.spatial import cKDTree

    t_phase = time.time()
    rng = np.random.default_rng(14)
    seconds = {}  # per section of the phase

    def lap(name):
        seconds[name] = round(time.time() - t_phase - sum(seconds.values()), 1)

    zero = ("window_resolve", "window_scatter", "fused_layer_eval", "window_resolve_flat")
    summary = {}
    knn_fn = wrappers["knn_scene"]

    def knn_gate(label, counts, captured, captures):
        """The kNN kernel's launches over a run whose preparation was
        captured `captures` times: n_sets in each first call's eager run,
        n_sets in each capture, none in a replay."""
        eager, caught = counts["knn_scene"] - captured["knn_scene"], captured["knn_scene"]
        assert eager == caught == n_sets * captures, (
            f"{label}: kNN launched {eager} times eagerly and {caught} in captures, "
            f"{n_sets} a preparation, {captures} captured")

    def kernels_gate(label, rec):
        counts, captured = rec.counts(), dict(rec.in_capture)
        log(f"[pyramid] {label}: launches {launch_split(counts, captured)}")
        for k in ("pcf_conv_linear", "pconv_pe_conv_linear"):
            assert counts[k] > 0, f"{label}: {k} was not launched"
        for k in zero:
            assert counts[k] == 0, f"{label}: {k} launched {counts[k]} times on plain edges"
        return counts, captured

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pyramid_") as root:
        data = rooms
        if data is None:
            data = os.path.join(root, "data")
            secs = synth_rooms(data, PYRAMID_TRAIN_ROOMS, PYRAMID_VAL_ROOMS)
            log(f"[pyramid] {PYRAMID_TRAIN_ROOMS} + {PYRAMID_VAL_ROOMS} synthetic rooms "
                f"written in {secs:.1f} s")

        # -- e: the loader alone, one epoch per mode --------------------------
        modes = {"host pyramid": dict(post_knn=False),
                 "post_knn": dict(post_knn=True),
                 "device_pyramid": dict(post_knn=False, device_pyramid=True)}
        loader_s, caps, first = {}, {}, None
        for mode, keys in modes.items():
            cfg_l = phase14_config(data, os.path.join(root, "exp_loader"))
            cfg_l.update(keys)
            loader, _, _, _ = getdataLoaders(cfg_l)
            caps[mode] = cfg_l.level_caps
            n, t = 0, time.perf_counter()
            for b in loader:
                if first is None and mode == "device_pyramid":
                    first = b
                n += 1
            loader_s[mode] = ((time.perf_counter() - t) / n, n)
        log("[pyramid] loader (NUM_WORKERS 0), host s per packed batch: " + "; ".join(
            f"{m}: {s:.4f} ({n} batches, caps {caps[m]})" for m, (s, n) in loader_s.items()))
        summary["loader"] = loader_s
        lap("rooms and loaders")
        # the device pyramid's caps: the post_knn loader's pinned ones, taken
        # over the same rooms' host pyramids with the same margin
        dev_caps = list(caps["post_knn"])

        # -- a: one batch's device pyramid against the host's ----------------
        cfg_d = phase14_config(data, os.path.join(root, "exp_check"))
        cfg_d.update(post_knn=False, device_pyramid=True, device_level_caps=dev_caps)
        b0 = first.to(device)
        args = post_knn_mod.static_args(cfg_d, b0.points[0].shape[0])
        n_sets = 3 * len(cfg_d.grid_size) - 2
        knn_fn.launches = 0
        with torch.no_grad():
            full, overflow = post_knn_mod.build_pyramid_packed(b0, *args[1:])
        assert not bool(overflow), "the device pyramid overflowed its caps"
        assert knn_fn.launches == n_sets, (
            f"the device pyramid launched the kNN kernel {knn_fn.launches} times, not {n_sets}")
        pts0, m0, bid0 = (first.points[0].numpy(), first.masks[0].numpy(),
                          first.bids[0].numpy())
        scenes = np.unique(bid0[m0])
        host = {int(sc): [pts0[m0 & (bid0 == sc)]] for sc in scenes}
        for lvl, g in enumerate(cfg_d.grid_size[1:], 1):
            dm = full.masks[lvl].cpu().numpy()
            dp, db = full.points[lvl].cpu().numpy()[dm], full.bids[lvl].cpu().numpy()[dm]
            worst = 0.0
            for sc in scenes:
                host[int(sc)].append(grid_subsampling(host[int(sc)][-1], sampleDl=float(g)))
                want, got = host[int(sc)][-1], dp[db == sc]
                assert got.shape == want.shape, (
                    f"level {lvl} scene {sc}: {got.shape[0]} voxels on the card, "
                    f"{want.shape[0]} on the host")
                # each host barycenter's nearest on the card, one to one (a
                # sort by coordinates would pair rows apart wherever two
                # voxels' coordinates tie within rounding)
                dist, near = cKDTree(got).query(want)
                assert len(np.unique(near)) == len(near), (
                    f"level {lvl} scene {sc}: barycenters not one to one")
                err = float(dist.max())
                assert err <= PYRAMID_ATOL, f"level {lvl} scene {sc}: barycenters {err:.3e}"
                worst = max(worst, err)
            log(f"[pyramid] device pyramid level {lvl} (grid {g}): cap {dm.shape[0]}, "
                f"{int(dm.sum())} voxels over {len(scenes)} scenes, each scene's count equal to "
                f"the host grid_subsampling's, barycenters within {worst:.3e}")

        def subsample_levels():
            pts, m, bid = b0.points[0], b0.masks[0], b0.bids[0]
            for lvl in range(1, len(cfg_d.grid_size)):
                sub = grid_subsample_fixed(pts, m, float(cfg_d.grid_size[lvl]),
                                           int(dev_caps[lvl]), features=b0.norms[0],
                                           bid=bid, n_scenes=int(cfg_d.BATCH_SIZE))
                pts, m, bid = sub["points"], sub["mask"], sub["bid"]
            return pts

        with torch.no_grad():
            _, sub_ms = graph_ms(subsample_levels)
            _, prep_ms = graph_ms(lambda: post_knn_mod.build_pyramid_packed(b0, *args[1:]))

        # -- b: every kNN call of that batch --------------------------------
        knn_ms, plain_ms, pairs, knn_err = knn_check(full, int(cfg_d.K_self[0]), rng,
                                                     int(cfg_d.BATCH_SIZE))
        bound_ms = pairs * KNN_OPS_PER_PAIR / PEAK_OPS[torch.float32] * 1e3
        log(f"[pyramid] one batch's device pyramid (replays): {prep_ms:.3f} ms, of which grid "
            f"subsampling {sub_ms:.3f} ms and the {n_sets} kNN calls {knn_ms:.3f} ms "
            f"({knn_ms / prep_ms:.1%}; the plain version {plain_ms:.1f} ms); {pairs:.3e} valid "
            f"pairs within scenes, bound {bound_ms:.4f} ms by f32 operations")
        summary.update(prep_ms=prep_ms, sub_ms=sub_ms, knn_ms=knn_ms, knn_plain_ms=plain_ms,
                       knn_pairs=pairs)
        knn_row = dict(name="knn_scene", route="cuda", source=SOURCES["knn_scene"][0],
                       replaces=SOURCES["knn_scene"][1], launches=n_sets, max_abs_err=knn_err,
                       ms=knn_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
                       library_ms=None, dtype="float32")
        lap("pyramid and kNN checks")
        del full, b0, first
        gc.collect()
        torch.cuda.empty_cache()

        # -- c, d: trainer.main under each key -------------------------------
        rec, prec = EntryRecorder(wrappers), PrepareRecorder()
        try:
            for mode in ("post_knn", "device_pyramid"):
                exp = os.path.join(root, f"exp_{mode}")
                cfg = phase14_config(data, exp)
                if mode == "device_pyramid":
                    cfg.update(post_knn=False, device_pyramid=True, device_level_caps=dev_caps)
                label = f"trainer.main, {mode}"
                rec.zero()
                recs = eager_recorders()
                n_preps = len(prec.preps)
                t0 = time.perf_counter()
                state = trainer.main(cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts, captured = kernels_gate(label, rec)
                train, val = rec.steps["train"][-1], rec.steps["eval"][-1]
                held_to_plain("[pyramid]", label, recs, counts, captured,
                              valid_rows(train.calls + val.calls))
                del recs
                gc.collect()
                assert len(prec.preps) == n_preps + 1, "main made more than one prepare"
                prep = prec.preps[-1]
                sigs = {c["batch"].signature() for c in train.calls}
                assert len(sigs) == 1 and train.graphs.captures == 1, (
                    f"{label}: {len(sigs)} signatures, {train.graphs.captures} captures")
                n_prep = len(train.calls) + len(val.calls)
                assert len(prep.calls) == n_prep, (len(prep.calls), n_prep)
                assert prep.graphs.captures == 1 and prep.graphs.replays == n_prep - 1, (
                    f"{label}: prepare captured {prep.graphs.captures} times, replayed "
                    f"{prep.graphs.replays} for {n_prep} batches")
                knn_gate(label, counts, captured, prep.graphs.captures)
                lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
                losses = [r["train_loss"] for r in lines if "train_loss" in r]
                assert losses and all(math.isfinite(v) for v in losses), losses
                assert any("val_miou" in r for r in lines), lines
                params, stats, epoch = CheckpointManager(os.path.join(exp, "model")).restore_eval()
                saved = {**params, **stats}
                for k, v in state.model.state_dict().items():
                    assert torch.equal(v.cpu(), saved[k]), f"{label}: checkpoint differs at {k}"
                calls, replays = list(train.calls), prep.graphs.replays
                steady = calls[ENTRY_STEADY_FROM:]
                end = rec.epoch_ends[-1]
                s_it = (end - steady[0]["start"]) / len(steady)
                batch, raw = calls[-1]["batch"], prep.calls[len(calls) - 1]["batch"]
                step_s = host_times(lambda: train(state, batch, 0), PYRAMID_REPLAY_WARMUP,
                                    PYRAMID_REPLAY_REPS)
                prep_s = host_times(lambda: prep(raw, device), PYRAMID_REPLAY_WARMUP,
                                    PYRAMID_REPLAY_REPS)
                valid = [int(m.sum()) for m in batch.masks]
                log(f"[pyramid] {label}: {wall:.1f} s in all, {len(calls)} steps, losses "
                    f"{losses}, checkpoint of epoch {epoch} equal to main's final state bit for "
                    f"bit; prepare captured once, replayed {replays} times in main; caps "
                    f"{[p.shape[0] for p in batch.points]}, valid {valid}; first step "
                    f"{calls[0]['ms'] / 1e3:.3f} s; {s_it:.4f} s/it over steps "
                    f"{ENTRY_STEADY_FROM + 1}-{len(calls)} against the train replay median "
                    f"{statistics.median(step_s):.4f} s and the prepare replay median "
                    f"{statistics.median(prep_s):.4f} s (each {len(step_s)} after "
                    f"{PYRAMID_REPLAY_WARMUP} warm-up, host clock to a synchronize); s from each "
                    f"step's start to the next's "
                    f"{[round(b['start'] - a['start'], 4) for a, b in zip(calls, calls[1:])]}; "
                    f"train graphs: {graph_pools(train)}")
                summary[mode] = dict(s_it=s_it, step=statistics.median(step_s),
                                     prepare=statistics.median(prep_s), counts=counts)
                if mode == "device_pyramid":
                    # B's and C's nei-mode calls of one eval forward at these shapes
                    conv_times(state.model, batch, summary)
                del state, train, val, batch, raw
                for steps in rec.steps.values():
                    steps.clear()
                prec.preps.clear()
                gc.collect()
                torch.cuda.empty_cache()
                lap(f"main, {mode}")

            # -- f: eval.simple.evaluate under device_pyramid ------------------
            exp = os.path.join(root, "exp_device_pyramid")
            cfg_e = phase14_config(data, exp)
            cfg_e.update(post_knn=False, device_pyramid=True,
                         eval_path=os.path.join(root, "eval_simple"))
            rec.zero()
            recs = eager_recorders()
            miou, mean_s = evaluate(cfg_e, pretrain_path=os.path.join(exp, "model"))
            counts, captured = kernels_gate("evaluate, device_pyramid", rec)
            knn_gate("evaluate, device_pyramid", counts, captured,
                     prec.preps[-1].graphs.captures)
            ev = rec.steps["eval"][-1]
            held_to_plain("[pyramid]", "evaluate, device_pyramid", recs, counts, captured,
                          valid_rows(ev.calls))
            del recs
            assert len(ev.calls) == 2 * PYRAMID_VAL_ROOMS, len(ev.calls)
            for i in range(PYRAMID_VAL_ROOMS):
                first_c, second = ev.calls[2 * i], ev.calls[2 * i + 1]
                assert sum(second["launches"].values()) == 0, second["launches"]
                n_valid = int(second["batch"].masks[0].sum())
                log(f"[pyramid] evaluate scene {i}: {n_valid} valid points, caps "
                    f"{[p.shape[0] for p in second['batch'].points]}, first call "
                    f"{first_c['ms']:.1f} ms, replay {second['ms']:.3f} ms "
                    f"({n_valid / second['ms'] * 1e3:.1f} valid points/s)")
            model = ev.calls[0]["model"]
            model_cpu = build(cfg_e, device="cpu")
            model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            batch = ev.calls[1]["batch"]
            with torch.no_grad():
                want = model_cpu.forward_batch(batch.to("cpu"))
            m0 = batch.masks[0].cpu()
            got = ev.calls[1]["logits"].cpu()
            diff = max_diff(got[m0], want[m0])
            assert torch.allclose(got[m0], want[m0], **MODEL_TOL), (
                f"evaluate scene 0: logits on the card {diff:.3e} from the CPU's")
            log(f"[pyramid] evaluate: mIoU {miou:.4f}, {mean_s * 1e3:.3f} ms per scene "
                f"(evaluate's own mean); scene 0's logits on the card against the CPU "
                f"(the same weights and batch): max abs err {diff:.3e} (MODEL_TOL)")
            summary["evaluate"] = [c["ms"] for c in ev.calls[1::2]]
            rec.steps["eval"].clear()
            gc.collect()
            lap("evaluate")

            # -- g: eval.voting.evaluate_voting under device_pyramid -----------
            cfg_v = phase14_config(data, exp)
            cfg_v.update(post_knn=False, device_pyramid=True,
                         eval_path=os.path.join(root, "eval_voting"))
            rec.zero()
            t0 = time.perf_counter()
            vmiou = evaluate_voting(cfg_v, pretrain_path=os.path.join(exp, "model"),
                                    vote_num=PYRAMID_VOTES)
            vwall = time.perf_counter() - t0
            counts, _ = kernels_gate("evaluate_voting, device_pyramid", rec)
            # eager preparations and captures alike: n_sets launches each
            assert counts["knn_scene"] > 0 and counts["knn_scene"] % n_sets == 0, counts
            vlog = [x for x in open(os.path.join(cfg_v.eval_path, "log.txt"))
                    if "Voting wall" in x][-1].split("INFO: ")[-1].strip()
            probs = {f: np.load(os.path.join(cfg_v.eval_path, f))
                     for f in sorted(os.listdir(cfg_v.eval_path)) if f.endswith("_probs.npy")}
            assert len(probs) == PYRAMID_VAL_ROOMS, sorted(probs)
            for f, p in probs.items():
                # a raw point without a vote would keep a row of zeros
                assert np.allclose(p.sum(-1), 1.0, atol=1e-4), f"{f}: a point without a vote"
            lap("voting")
            # scene 0 at PYRAMID_CPU_VOTES, on the card and on the CPU
            one = {}
            for where, kw in (("card", dict(pretrain_path=os.path.join(exp, "model"))),
                              ("cpu", dict(state=model_cpu))):
                cfg_c = cfg_v.copy()
                cfg_c.eval_path = os.path.join(root, f"eval_voting_{where}")
                evaluate_voting(cfg_c, vote_num=PYRAMID_CPU_VOTES, max_scenes=1, **kw)
                one[where] = cfg_c.eval_path
            name = sorted(probs)[0]
            got, want = (np.load(os.path.join(one[w], name)) for w in ("card", "cpu"))
            verr = float(np.abs(got - want).max())
            assert verr <= VOTE_ATOL, f"voting {name}: card against CPU {verr:.3e}"
            top2 = np.sort(want, -1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > VOTE_ATOL
            assert (got.argmax(-1)[sure] == want.argmax(-1)[sure]).all(), (
                f"voting {name}: labels differ off the near-ties")
            log(f"[pyramid] evaluate_voting ({PYRAMID_VOTES} votes, cut from 8): mIoU "
                f"{vmiou:.4f}, {vwall:.1f} s from the call; every raw point voted in all "
                f"{len(probs)} scenes; {name} at {PYRAMID_CPU_VOTES} vote(s), the card "
                f"against the CPU: max abs err {verr:.3e} "
                f"({int((~sure).sum())} near-ties of {sure.shape[0]} points); {vlog}")
            summary["voting"] = vlog
            lap("voting on the CPU")
        finally:
            rec.restore()
            prec.restore()
    log(f"[pyramid] summary ({smi}): {json.dumps(summary, default=str)}; phase 14 "
        f"{time.time() - t_phase:.1f} s ({seconds})")
    return knn_row


# phase 15's rooms: tools/make_synth_dataset.py, 4 validation rooms at its
# 15,000 points a room, packed one per batch as the serving CLI packs them
SERVE_ROOMS, SERVE_ROOM_POINTS = 4, 15000
# phase 15: replays of predict_packed and make_eval_step timed in turns
SERVE_WARMUP, SERVE_REPS = 2, 10
# phase 15: the exported replay against the live captured step of the same
# weights, beyond which a profiled replay of each is broken down by kernel
SERVE_RATIO_PROFILE = 1.2


def op_call(name, args):
    """(wrapper name, args, kwargs) of a kernel's custom-operator call, put
    back into its wrapper's form for replay_against_plain."""
    from pcf_torch.ops.kernels.layer_eval import _pairs
    from pcf_torch.ops.kernels.pconv_fused import edges_of
    from pcf_torch.ops.window import WindowedEdges

    if name == "pcf::conv_linear":
        guided, feats, nei, wr, lt, extra, weights, lw, lb, _ = args
        return ("pcf_conv_linear" if guided else "pconv_pe_conv_linear",
                (feats, edges_of(nei, wr, lt), extra, weights, lw, lb), {})
    if name == "pcf::layer_eval":
        (table, geo, nei, wr, lt, cxyz, cnorm, mlp, layers, lw, lb, Cx, Cg, Cs, use_vi,
         pe_on_vi, concat_wni, strided, heads) = args
        return ("fused_layer_eval",
                (table, geo, WindowedEdges(nei, wr, lt), cxyz, cnorm, *_pairs(mlp, layers),
                 lw, lb),
                dict(Cx=Cx, Cg=Cg, Cs=Cs, use_vi=use_vi, pe_on_vi=pe_on_vi,
                     concat_wni=concat_wni, strided=strided, num_heads=heads))
    return name.removeprefix("pcf::"), args, {}


def op_recorder():
    """A TorchDispatchMode that sees every call of a kernel's custom operator
    (an exported program calls them, not the wrappers): `eager` and
    `captured` count them by wrapper name outside and inside a graph
    capture, and `recs()` gives the eager ones' arguments, copied, as
    EagerRecorder-like objects for replay_against_plain."""
    from types import SimpleNamespace

    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.eager, self.captured = {}, {}, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if name.startswith("pcf::"):
                wrapper, a, kw = op_call(name, args)
                if torch.cuda.is_current_stream_capturing():
                    self.captured[wrapper] = self.captured.get(wrapper, 0) + 1
                else:
                    self.eager[wrapper] = self.eager.get(wrapper, 0) + 1
                    self.calls.setdefault(wrapper, []).append((snapshot(a), snapshot(kw)))
            return func(*args, **(kwargs or {}))

        def recs(self):
            return [SimpleNamespace(name=k, calls=v) for k, v in self.calls.items()]

    return OpRecorder()


def serve_start(pretrain=None, device="cuda") -> dict:
    """Phase 15's first half, which the script starts before phase 14 so
    that the exports run beside it: SERVE_ROOMS synthetic rooms and phase
    15's configuration (phase 13's, its level caps pinned to those rooms:
    one bucket) in a temporary directory of its own, and `python -m
    pcf_torch.serve.export` started for the standard program (cuda and cpu:
    phase 15 holds the card's against the CPU's) and the fused_eval one
    (cuda: no gate reads its CPU program), two processes at once.
    `pretrain` is a checkpoint directory of that configuration (phase 13's);
    without one, seeded weights with BN calibrated once are saved."""
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.scannet import ScanNetDataset, estimate_level_caps
    from pcf_torch.entry import build
    from pcf_torch.train.checkpoint import CheckpointManager
    from pcf_torch.train.state import create_train_state, make_optimizer

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    data = os.path.join(root, "data")
    synth_rooms(data, 0, SERVE_ROOMS, SERVE_ROOM_POINTS)
    cfg = phase13_config(data, os.path.join(root, "exp"))
    val = ScanNetDataset(cfg, "validation", seed=cfg.manual_seed)
    caps = estimate_level_caps([val], 1, cfg.bucket_multiple, sample=SERVE_ROOMS,
                               margin=cfg.level_caps_margin)
    cfg.level_caps = caps
    if pretrain is None:
        # seeded weights, BN calibrated by one train-mode pass over a room
        pretrain = os.path.join(root, "ckpt")
        model = build(cfg, device=device)
        with torch.no_grad():
            model.train()
            model.forward_batch(pack_scenes([val[0]], level_caps=caps).to(device))
            model.eval()
        CheckpointManager(pretrain).save(0, create_train_state(model, make_optimizer(cfg)[0]))
        del model
        source = "seeded weights, BN calibrated once"
    else:
        source = f"phase 13's checkpoint ({pretrain})"
    procs = {}
    for kind, extra, platforms in (("standard", {}, (device, "cpu")),
                                   ("fused_eval", {"fused_eval": True}, (device,))):
        path = os.path.join(root, f"{kind}.json")
        with open(path, "w") as f:
            json.dump({**cfg, **extra}, f)
        procs[kind] = subprocess.Popen(
            [sys.executable, "-m", "pcf_torch.serve.export", "--config", path,
             "--pretrain_path", pretrain, "--out", os.path.join(root, kind),
             "--platforms", ",".join(dict.fromkeys(platforms))],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return dict(root=root, data=data, cfg=cfg, pretrain=pretrain, source=source, procs=procs,
                t0=time.perf_counter())


def serve_phase(wrappers, smi, pretrain=None, device="cuda", started=None):
    """Phase 15: the serving path on the card (see the module docstring),
    the programs served on `device`, from the exports serve_start started
    (`started`; else started here, from `pretrain`)."""
    from pcf_torch.entry import build
    from pcf_torch.nn.layers import PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE
    from pcf_torch.parallel.mesh import make_eval_step
    from pcf_torch.serve import ServingModel
    from pcf_torch.serve.predict import load_scene
    from pcf_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    started = started or serve_start(pretrain, device)
    conv_layers = (PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE)
    root, data, cfg = started["root"], started["data"], started["cfg"]
    pretrain, source = started["pretrain"], started["source"]
    try:
        scenes = sorted(glob.glob(os.path.join(data, "val", "*.npz")))
        # -- export: both artifacts, one process each, started together -------
        for kind, proc in started["procs"].items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, f"export of {kind} failed:\n{out[-4000:]}"
            for line in out.splitlines():
                if line.startswith(("exported", "derived", "restored", "params.npz")):
                    log(f"[serve] export {kind}: {line}")
        export_wall = time.perf_counter() - started["t0"]
        waited = time.perf_counter() - t_phase
        arts = {kind: os.path.join(root, kind) for kind in started["procs"]}
        for kind, art in arts.items():
            sizes = {f: os.path.getsize(os.path.join(art, f)) for f in sorted(os.listdir(art))}
            log(f"[serve] artifact {kind} ({source}): " + ", ".join(
                f"{f} {n / 2**20:.2f} MiB" for f, n in sizes.items()))
        log(f"[serve] both exports (standard for {device} and cpu, fused_eval for {device}) "
            f"done {export_wall:.1f} s after their start, in parallel; phase 15 waited "
            f"{waited:.1f} s for them")

        # -- the CLI in a fresh process: labels, and no model code loaded -------
        preds = os.path.join(root, "predictions")
        code = ("import json, runpy, sys; sys.argv = ['predict', '--artifact', {a!r}, "
                "'--scenes', {g!r}, '--out', {o!r}, '--device', {d!r}]; "
                "runpy.run_module('pcf_torch.serve.predict', run_name='__main__'); "
                "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
                "('pcf_torch.models', 'pcf_torch.nn')) or m.split('.')[0] in "
                "('jax', 'pcf_tpu'))))").format(a=arts["standard"], o=preds, d=device,
                                                 g=os.path.join(data, "val", "*.npz"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True,
                           text=True)
        assert r.returncode == 0, f"pcf_torch.serve.predict failed:\n{r.stderr[-4000:]}"
        lines = r.stdout.strip().splitlines()
        assert json.loads(lines[-1]) == [], f"the serving process loaded {lines[-1]}"
        for line in lines[:-1]:
            log(f"[serve] predict CLI: {line}")
        log(f"[serve] predict CLI process: {time.perf_counter() - t0:.1f} s wall; no "
            f"pcf_torch.models, pcf_torch.nn, jax or pcf_tpu module loaded")
        for path in scenes:
            name = os.path.splitext(os.path.basename(path))[0]
            labels = np.loadtxt(os.path.join(preds, f"{name}.txt"), dtype=np.int64)
            n = len(load_scene(path)[0])
            assert labels.shape == (n,) and labels.min() >= 0 and (
                labels.max() < cfg.num_classes), f"{name}: labels {labels.shape}"

        # -- in this process: the programs' kernels, against the live step ------
        model = build(cfg, device=device)
        params, stats, _ = CheckpointManager(pretrain).restore_eval()
        model.load_state_dict({**params, **stats})
        model.eval()
        n_conv = sum(isinstance(m, conv_layers) for m in model.modules())
        eval_step = make_eval_step(cfg)
        coord, norm, feats = load_scene(scenes[0])
        summary = {}
        for kind, art in arts.items():
            t0 = time.perf_counter()
            served = ServingModel(art, device=device)
            load_s = time.perf_counter() - t0
            batch, _ = served.pack_scene(coord, norm, feats)
            valid = int(batch.masks[0].sum())
            for fn in wrappers.values():
                fn.launches = 0
            rec = op_recorder()
            t0 = time.perf_counter()
            with rec:
                first = served.predict_packed(batch)
                torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in wrappers.items()}
            captured = {k: rec.captured.get(k, 0) for k in wrappers}
            capture_ms = [e.capture_ms for e in served.graphs.entries.values()]
            log(f"[serve] {kind}: load {load_s:.2f} s; first predict_packed (eager run and "
                f"capture) {first_s:.2f} s, capture ms {capture_ms}; launches "
                f"{launch_split(counts, captured)}")
            for k, n in counts.items():
                assert n == rec.eager.get(k, 0) + captured[k], (
                    f"{kind}: {k} launched {n} times, {rec.eager.get(k, 0)} calls eager and "
                    f"{captured[k]} in the capture")
            eager = {k: rec.eager.get(k, 0) for k in wrappers}
            if kind == "standard":
                for k in ("window_resolve", "pcf_conv_linear", "pconv_pe_conv_linear"):
                    assert eager[k] > 0, f"the exported program did not launch {k}"
            else:
                assert eager["fused_layer_eval"] == n_conv, (
                    f"E launched {eager['fused_layer_eval']} times, {n_conv} conv layers")
                assert eager["pcf_conv_linear"] == eager["pconv_pe_conv_linear"] == 0, eager
            res = replay_against_plain(rec.recs())
            for k, (n, _) in res.items():
                assert n == eager.get(k, 0), f"{kind}: {n} {k} calls kept, {eager.get(k, 0)}"
            log(f"[serve] {kind}: every eager kernel call of the program against its plain "
                "version: " + "; ".join(
                    f"{KERNEL_LETTERS[k]} {n} calls, " + (
                        "bit-exact" if k == "window_resolve" else f"max abs err {e:.3e}")
                    for k, (n, e) in res.items() if n))
            del rec

            model.cfg.fused_eval = kind == "fused_eval"
            want = eval_step(model, batch)   # the eager run of its first call
            again = eval_step(model, batch)  # a replay
            got = served.predict_packed(batch)
            same_as_eager(f"serve {kind}: predict_packed replay against make_eval_step", got,
                          want, again, "bfloat16")
            del first
            times = timed_in_turns({"predict_packed": lambda: served.predict_packed(batch),
                                    "make_eval_step": lambda: eval_step(model, batch)},
                                   SERVE_WARMUP, SERVE_REPS)
            ratio = statistics.median(times["predict_packed"]) / statistics.median(
                times["make_eval_step"])
            prof = {name: replay_profile(fn) for name, fn in (
                ("predict_packed", lambda: served.predict_packed(batch)),
                ("make_eval_step", lambda: eval_step(model, batch)))}
            log(f"[serve] {kind} replays ({smi}), {SERVE_REPS} after {SERVE_WARMUP} warm-up "
                f"in turns: {turns_summary(times, valid)}; exported / live {ratio:.3f}; "
                "profiled replay: " + "; ".join(
                    f"{n} {p[3]} kernels, device busy {p[1]:.3f} ms of {p[2]:.3f} ms"
                    for n, p in prof.items()))
            if ratio > SERVE_RATIO_PROFILE:
                for n, fn in (("predict_packed", lambda: served.predict_packed(batch)),
                              ("make_eval_step", lambda: eval_step(model, batch))):
                    profile_run(fn, f"serve {kind} {n} replay")
            summary[kind] = dict(load_s=load_s, first_s=first_s, ratio=ratio)

            if kind == "standard":
                # both programs are bf16 and round at the same places, in
                # other summation orders: on trained weights they differ by
                # about bf16's own error (MODEL_TOL is f32's). So each is held
                # to the f32 standard forward of the same weights, as phase 13
                # holds the bf16 fused forward: the card's RMS error at most
                # FUSED_BF16_WITNESS times the CPU program's
                cpu = ServingModel(art, device="cpu")
                t0 = time.perf_counter()
                on_cpu = cpu.predict_packed(batch)
                cpu_s = time.perf_counter() - t0
                m0 = batch.masks[0]
                card, on_cpu = served.predict_packed(batch)[m0].cpu(), on_cpu[m0]
                cfg32 = cfg.copy()
                cfg32.compute_dtype = "float32"
                model32 = build(cfg32, device=device)
                model32.load_state_dict(model.state_dict())
                with torch.no_grad():
                    want32 = model32.eval().forward_batch(batch.to(device))[m0].cpu()
                scale = want32.abs().max().item()
                card_err, cpu_err = rms_diff(card, want32), rms_diff(on_cpu, want32)
                log(f"[serve] standard scene 0 ({cpu_s:.1f} s on the CPU): the card's program "
                    f"against the CPU program max abs err {max_diff(card, on_cpu):.3e} "
                    f"(MODEL_TOL allclose "
                    f"{torch.allclose(card.float(), on_cpu.float(), **MODEL_TOL)}); against "
                    f"the f32 standard forward (logit scale {scale:.3e}) RMS err: the card "
                    f"{card_err:.3e}, the CPU {cpu_err:.3e}, ratio {card_err / cpu_err:.3f} "
                    f"(FUSED_BF16_WITNESS)")
                assert card_err <= FUSED_BF16_WITNESS * cpu_err, (
                    f"the card's program is {card_err:.3e} (RMS) from the f32 forward, the "
                    f"CPU program {cpu_err:.3e}")
                del cpu, on_cpu, model32

                # predict_scene per scene, after the first call captured the bucket
                for path in scenes:
                    c, n_, f_ = load_scene(path)
                    b, _ = served.pack_scene(c, n_, f_)
                    served.predict_scene(c, n_, f_)
                    sp = served.last_split
                    ms = sum(sp.values())
                    log(f"[serve] predict_scene {os.path.basename(path)}: {len(c)} points, "
                        f"{int(b.masks[0].sum())} valid, {ms:.2f} ms ("
                        + ", ".join(f"{k} {v:.2f}" for k, v in sp.items())
                        + f" ms), {int(b.masks[0].sum()) / ms * 1e3:.1f} valid points/s")
            del served
            gc.collect()
        model.cfg.fused_eval = False
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[serve] summary ({smi}): {json.dumps(summary)}; phase 15 "
        f"{time.perf_counter() - t_phase:.1f} s")



# phase 16: trainer.main under multi_host in a group of one rank, on rooms of
# tools/make_synth_dataset.py (train, val)
MESH_ROOMS = (8, 2)


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class CollectiveCounter:
    """Counts the torch.distributed collectives the port calls (all_reduce;
    all_gather_into_tensor and reduce_scatter_tensor, spatial sharding's),
    and their output bytes, outside CUDA graph captures, while on (the
    port's mesh, SyncBN and nn/sharded.py call them through the module
    attributes). `calls` and `bytes` are all_reduce's."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.fns = {n: getattr(dist, n) for n in self.NAMES}
        self.counts = {n: [0, 0] for n in self.NAMES}
        for n in self.NAMES:
            setattr(dist, n, self._counted(n))

    def _counted(self, name):
        fn = self.fns[name]

        def counted(t, *a, **kw):
            if not torch.cuda.is_current_stream_capturing():
                self.counts[name][0] += 1
                self.counts[name][1] += t.numel() * t.element_size()
            return fn(t, *a, **kw)

        return counted

    @property
    def calls(self) -> int:
        return self.counts["all_reduce"][0]

    @property
    def bytes(self) -> int:
        return self.counts["all_reduce"][1]

    def summary(self) -> str:
        return ", ".join(f"{n} {c} calls ({b / 2**20:.2f} MiB)"
                         for n, (c, b) in self.counts.items())

    def restore(self):
        for n, fn in self.fns.items():
            setattr(self.dist, n, fn)


def state_bits_equal(label, a, ma, b, mb):
    """Two train states and their metrics equal bit for bit: the metrics,
    every parameter and its .grad, every BN running statistic."""
    for k in ma:
        assert torch.equal(ma[k], mb[k]), f"{label}: metric {k} differs"
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), f"{label}: parameter {k} differs"
        assert (p.grad is None) == (q.grad is None), f"{label}: gradient {k}"
        assert p.grad is None or torch.equal(p.grad, q.grad), f"{label}: gradient {k} differs"
    for (k, u), v in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(u, v), f"{label}: buffer {k} differs"


def mesh_phase(cfg, batch, wrappers, smi):
    """Phase 16: data-parallel training on a mesh of one NCCL rank (see the
    module docstring)."""
    import torch.distributed as dist

    from pcf_torch.entry import build_training
    from pcf_torch.parallel import mesh as mesh_mod
    from pcf_torch.train import trainer
    from pcf_torch.train.checkpoint import CheckpointManager

    def launched():
        return {k: fn.launches for k, fn in wrappers.items()}

    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_mod.make_mesh()
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cuda", 0)), mesh
        valid = int(batch.masks[0].sum())
        for dtype_name in ("float32", "bfloat16"):
            cfg_m = cfg.copy()
            cfg_m.update(compute_dtype=dtype_name, bn_axis_name=mesh_mod.AXIS, sync_bn=True)
            label = f"[mesh] {dtype_name}"
            seed = 5
            # the eager bodies: counts from 0 over the mesh step
            (sa, _), (sb, _) = (build_training(cfg_m.copy(), device="cuda", seed=0),
                                build_training(cfg_m.copy(), device="cuda", seed=0))
            with_mesh = mesh_mod.make_eager_train_step(cfg_m, mesh)
            without = mesh_mod.make_eager_train_step(cfg_m)
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            coll = CollectiveCounter()
            try:
                _, ma = with_mesh(sa, batch, seed)
                torch.cuda.synchronize()
            finally:
                coll.restore()
            counts = launched()
            for k in ("window_resolve", "pcf_conv_linear", "pconv_pe_conv_linear",
                      "window_scatter"):
                assert counts[k] > 0, f"{label}: {k} was not launched by the mesh step"
            _, mb = without(sb, batch, mesh_mod.step_seed(seed, 0))
            state_bits_equal(f"{label} eager", sa, ma, sb, mb)
            log(f"{label}: eager train step on a 1-rank NCCL mesh (SyncBN on) against "
                f"mesh=None (seed folded with rank 0): loss, metrics, every gradient, "
                f"parameter and BN statistic equal bit for bit; launches {counts}; "
                f"{coll.calls} all_reduce calls a step, {coll.bytes / 2**20:.2f} MiB")
            ev = (mesh_mod.make_eager_eval_step(cfg_m, mesh)(sa, batch),
                  mesh_mod.make_eager_eval_step(cfg_m)(sb, batch))
            assert torch.equal(*ev), f"{label}: eager eval logits differ"
            del sa, sb, with_mesh, without, ev

            # the captured steps: the first call eager and captured, the
            # second a replay; both held bit for bit
            (sa, _), (sb, _) = (build_training(cfg_m.copy(), device="cuda", seed=0),
                                build_training(cfg_m.copy(), device="cuda", seed=0))
            cap_mesh, cap = mesh_mod.make_train_step(cfg_m, mesh), mesh_mod.make_train_step(cfg_m)
            for i in range(2):
                _, ma = cap_mesh(sa, batch, seed + i)
                _, mb = cap(sb, batch, mesh_mod.step_seed(seed + i, 0))
                state_bits_equal(f"{label} {'replay' if i else 'first call'}", sa, ma, sb, mb)
            assert cap_mesh.graphs.captures == 1 and cap_mesh.graphs.replays == 1, (
                cap_mesh.graphs.captures, cap_mesh.graphs.replays)
            evs = (mesh_mod.make_eval_step(cfg_m, mesh), mesh_mod.make_eval_step(cfg_m))
            for i in range(2):
                a, b = evs[0](sa, batch), evs[1](sb, batch)
                assert torch.equal(a, b), f"{label}: eval {'replay' if i else 'call'} differs"
            seeds = iter(range(100, 10 ** 6))
            times = timed_in_turns({"mesh": lambda: cap_mesh(sa, batch, next(seeds)),
                                    "mesh=None": lambda: cap(sb, batch, next(seeds))},
                                   STEP_WARMUP, STEP_REPS)
            log(f"{label}: captured train step and eval step, first call and replay, equal "
                f"to mesh=None bit for bit; replay ms, {STEP_REPS} after {STEP_WARMUP} "
                f"warm-up in turns: {turns_summary(times, valid)}")
            del sa, sb, cap_mesh, cap, evs, a, b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # trainer.main under multi_host: it joins a torchrun-style group of one
    # rank from the environment (the bootstrap), logs and checkpoints on rank 0
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
            data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
            synth_rooms(data, *MESH_ROOMS, ENTRY_ROOM_POINTS)
            cfg_h = phase13_config(data, exp)
            cfg_h.multi_host = True
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            state = trainer.main(cfg_h)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launched()
            assert dist.is_initialized() and dist.get_world_size() == 1
            for k in ("window_resolve", "pcf_conv_linear", "pconv_pe_conv_linear",
                      "window_scatter"):
                assert counts[k] > 0, f"[mesh] main: {k} was not launched"
            logtext = open(os.path.join(exp, "log.txt")).read()
            assert "rank 0 of 1" in logtext, "main did not join the group"
            lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
            losses = [r["train_loss"] for r in lines if "train_loss" in r]
            assert losses and all(math.isfinite(v) for v in losses), lines
            params, stats, epoch = CheckpointManager(os.path.join(exp, "model")).restore_eval()
            ckpt = {**params, **stats}
            for k, v in state.model.state_dict().items():
                assert torch.equal(v.cpu(), ckpt[k]), f"[mesh] main: checkpoint differs at {k}"
            log(f"[mesh] trainer.main, multi_host in a 1-rank torchrun-style group (NCCL): "
                f"{state.step} steps in {wall:.1f} s, launches {counts}, train losses "
                f"{losses}, checkpoint of epoch {epoch} equal to main's state bit for bit")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase 17: each off-default key of the model, flipped on the flagship's
# PCF_Normal at the entry size (2 x 4000 points, windowed, K=16)
VARIANT_KEYS = (("transformer_type", "PointTransformer"), ("attention_type", "QK"),
                ("cm_geom", True), ("remat_layers", True), ("remat_deconv", True))


def variants_phase(wrappers, smi, device="cuda"):
    """Phase 17: the off-default variants on the card (see the module
    docstring)."""
    from pcf_torch.entry import build, build_training, flagship_batch
    from pcf_torch.models import PointConvFormer_Classification
    from pcf_torch.nn.init import init_params
    from pcf_torch.nn.layers import set_generator
    from pcf_torch.parallel.mesh import make_eager_train_step, step_seed

    cfg0, batch = flagship_batch(level0_points=4000, bucket=1024, window_gather=True,
                                 device=device)
    cfg0.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
    m = batch.masks[0].cpu()
    cpu_batch = batch.to("cpu")
    for key, value in VARIANT_KEYS:
        label = f"[variants] {key}={value}"
        cfg_k = cfg0.copy()
        cfg_k[key] = value
        model = build(cfg_k, device=device, seed=1)
        with torch.no_grad():
            model.train()
            model.forward_batch(batch)
            model.eval()
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            got = model.forward_batch(batch)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in wrappers.items()}
            cpu_model = build(cfg_k, device="cpu", seed=1)
            cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            want = cpu_model.forward_batch(cpu_batch)
        got = got.cpu()
        err = (got[m] - want[m]).abs().max().item()
        expect = ("window_resolve", "pconv_pe_conv_linear") + (
            () if key == "transformer_type" else ("pcf_conv_linear",))
        for k in expect:
            assert counts[k] > 0, f"{label}: {k} was not launched by the forward"
        assert torch.allclose(got[m], want[m], **MODEL_TOL), f"{label}: logits differ: {err:.3e}"
        del model, cpu_model

        # a captured train step against its eager body (SGD, every ReLU and
        # max smooth, as phase 12)
        cfg_t = cfg_k.copy()
        cfg_t.update(compute_dtype="float32", optimizer="SGD")
        (sa, captured), (sb, _) = (build_training(cfg_t.copy(), device=device, seed=0),
                                   build_training(cfg_t.copy(), device=device, seed=0))
        eager = make_eager_train_step(cfg_t)
        losses = ([], [])
        with smooth_kinks():
            for i in range(2):
                if i == 1:
                    for fn in wrappers.values():
                        fn.launches = 0
                _, ma = captured(sa, batch, step_seed(0, i))
                if i == 1:
                    torch.cuda.synchronize()
                    replayed = {k: fn.launches for k, fn in wrappers.items()}
                    for fn in wrappers.values():
                        fn.launches = 0
                _, mb = eager(sb, batch, step_seed(0, i))
                losses[0].append(ma["loss"].item())
                losses[1].append(mb["loss"].item())
        step_counts = {k: fn.launches for k, fn in wrappers.items()}
        assert captured.graphs.captures == 1 and captured.graphs.replays == 1
        assert not any(replayed.values()), f"{label}: the replay launched {replayed} eagerly"
        for k in expect + ("window_scatter",):
            assert step_counts[k] > 0, f"{label}: {k} was not launched by the train step"
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        over, worst, worst_key = grad_ratios(
            {k: p.detach() for k, p in sa.model.named_parameters()},
            {k: p.detach() for k, p in sb.model.named_parameters()})
        assert all(math.isfinite(v) for v in losses[0] + losses[1]), losses
        assert rel <= GRAPH_LOSS_RTOL, f"{label}: captured loss differs by {rel:.3e}"
        assert over == 0, f"{label}: parameter {worst_key} differs after the captured steps"
        line = (f"{label}: f32 forward on the card against the CPU max abs err {err:.3e} "
                f"(launches {counts}); captured SGD steps against the eager body: losses "
                f"{[round(v, 6) for v in losses[0]]} (max rel {rel:.2e}), parameters worst "
                f"{worst:.3f} of phase 8's tolerance; the eager step launched {step_counts}")
        del sa, sb, captured, eager

        if key.startswith("remat"):
            # the gradients with and without the key, and each step's peak
            grads, peaks = {}, {}
            for on in (True, False):
                cfg_r = cfg_t.copy()
                cfg_r[key] = on
                state, _ = build_training(cfg_r, device=device, seed=0)
                step = make_eager_train_step(cfg_r)
                peak, resident = forward_peak(lambda: step(state, batch, 7))
                peaks[on] = peak - resident
                grads[on] = {k: p.grad.clone() for k, p in state.model.named_parameters()}
                del state, step
            over, worst, worst_key = grad_ratios(grads[True], grads[False])
            same = sum(torch.equal(grads[True][k], grads[False][k]) for k in grads[False])
            assert over == 0, f"{label}: gradient {worst_key} differs with remat"
            line += (f"; gradients with {key} against without: {same} of {len(grads[False])} "
                     f"equal bit for bit, worst {worst:.3f} of phase 8's tolerance; the step's "
                     f"peak memory {peaks[True] / 2**20:.1f} MiB with, "
                     f"{peaks[False] / 2**20:.1f} MiB without")
            del grads
        log(line)
        gc.collect()

    # classification: the flagship width over the batch's 2 scenes as clouds
    cfg_c = cfg0.copy()
    cfg_c.update(num_classes=10, max_clouds=2, BATCH_SIZE=2)
    model = PointConvFormer_Classification(cfg_c)
    init_params(model, torch.Generator().manual_seed(3))
    model = model.to(device)
    bids = batch.bids[-1]
    labels = torch.tensor([3, 7], device=device)
    with torch.no_grad():
        model.train()
        model.forward_batch(batch, bids)
        model.eval()
        for fn in wrappers.values():
            fn.launches = 0
        logits = model.forward_batch(batch, bids)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        cpu_model = PointConvFormer_Classification(cfg_c)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_model.eval()
        want = cpu_model.forward_batch(cpu_batch, bids.cpu())
    err = (logits.cpu() - want).abs().max().item()
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert torch.allclose(logits.cpu(), want, **MODEL_TOL), f"classification logits: {err:.3e}"
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model.train()
    set_generator(model, torch.Generator(device).manual_seed(0))
    losses = []
    for _ in range(2):
        opt.zero_grad()
        loss = F.cross_entropy(model.forward_batch(batch, bids), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    set_generator(model, None)
    assert all(math.isfinite(v) for v in losses), losses
    assert counts["window_resolve"] > 0 and counts["pcf_conv_linear"] > 0, counts
    log(f"[variants] PointConvFormer_Classification, PCF_Normal width, 2 clouds: logits on the "
        f"card against the CPU max abs err {err:.3e} (launches {counts}); 2 Adam train steps, "
        f"losses {[round(v, 5) for v in losses]}")


# phase 18: the spatial steps on ranks of a gloo group on the one card
# (NCCL refuses two ranks on one card), each a process of this script
SPATIAL_RANKS = 2
SPATIAL_SEED = 5


def spatial_rank(argv) -> int:
    """`chip_smoke.py --spatial-rank RANK WORLD PORT DIR [DEVICE]`: one rank of
    phase 18's gloo group on DEVICE (cuda:0). It loads DIR/inputs.pt (the configurations,
    the weights, the batch), runs the eager spatial eval step in both dtypes
    and one f32 train step (every ReLU and max smooth), and saves what they
    gave to DIR/rank<RANK>.pt."""
    import torch.distributed as dist

    from pcf_torch.entry import build, build_training
    from pcf_torch.parallel.mesh import make_mesh
    from pcf_torch.parallel.spatial import make_spatial_eval_step, make_spatial_train_step

    rank, world, port, root = int(argv[0]), int(argv[1]), argv[2], argv[3]
    device = torch.device(argv[4] if len(argv) > 4 else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_mesh(world, device)
    p = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    batch = p["batch"].to(device)
    out = {"logits": {}}
    for dtype_name, (cfg_d, weights) in p["evals"].items():
        model = build(cfg_d, device=device, seed=0)
        model.load_state_dict(weights)
        out["logits"][dtype_name] = make_spatial_eval_step(cfg_d, mesh)(model, batch).cpu()
    cfg_t = p["train_cfg"]
    state, _ = build_training(cfg_t, device=device, seed=0)
    with smooth_kinks():
        _, m = make_spatial_train_step(cfg_t, mesh)(state, batch, SPATIAL_SEED)
    torch.cuda.synchronize()
    out["metrics"] = {k: v.cpu() for k, v in m.items()}
    out["grads"] = {k: q.grad.cpu().double() for k, q in state.model.named_parameters()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def spatial_ranks(root, world, timeout=300.0, device="cuda:0") -> list:
    """Run spatial_rank on `world` ranks of this script; their results."""
    port = str(free_port())
    logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spatial-rank",
                               str(r), str(world), port, root, device], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            text = open(os.path.join(root, f"rank{r}.log")).read()
            raise RuntimeError(f"[spatial] gloo rank {r} of {world} on the card exited with "
                               f"{p.returncode}:\n{text[-4000:]}")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spatial_held(label, a, ma, b, mb, f32_grads=None):
    """Phase 18: a spatial train step's state and metrics against the
    unsharded step's (see spatial_phase), logged, then asserted. f32: the
    loss within GRAPH_LOSS_RTOL, the histograms equal, every gradient and BN
    statistic within phase 8's tolerance. bf16 (`f32_grads`, the f32
    unsharded step's gradients on the same weights): a one-step difference of
    a bf16 gradient sum moves others by more than that tolerance, so, as
    phase 8 holds the card to float64, the spatial step's gradient tree no
    farther from the f32 one than TRAIN_WITNESS times the unsharded step's;
    the loss within BF16_REL."""
    loss, want = ma["loss"].item(), mb["loss"].item()
    rel = abs(loss - want) / abs(want)
    got = {k: p.grad.detach().double() for k, p in a.model.named_parameters()}
    ref = {k: p.grad.detach().double() for k, p in b.model.named_parameters()}
    over, worst, key = grad_ratios(got, ref)
    stats = dict(a.model.named_buffers())
    ref_stats = {k: v for k, v in b.model.named_buffers() if k.endswith(("mean", "var"))}
    s_over, s_worst, s_key = grad_ratios({k: stats[k] for k in ref_stats}, ref_stats)
    same = sum(torch.equal(got[k], ref[k]) for k in ref)
    hists = all(torch.equal(ma[k], mb[k]) for k in ("intersection", "union", "target"))
    text = (f"{label}: loss {loss:.7f} against {want:.7f} (rel {rel:.2e}, equal bit for bit: "
            f"{loss == want}), histograms equal: {hists}; {same} of {len(ref)} gradients equal "
            f"bit for bit, the worst at {worst:.3f} of phase 8's tolerance ({key}), tree error "
            f"{tree_error(got, ref):.3e}; BN statistics worst at {s_worst:.3f} of it ({s_key})")
    if f32_grads is None:
        log(text)
        assert rel <= GRAPH_LOSS_RTOL, f"{label}: the loss differs by {rel:.3e}"
        assert hists, f"{label}: the histograms differ"
        assert over == 0, f"{label}: {over} gradients beyond tolerance ({key})"
        assert s_over == 0, f"{label}: BN statistic {s_key} beyond tolerance"
        return
    e_sp, e_un = tree_error(got, f32_grads), tree_error(ref, f32_grads)
    log(f"{text}; gradient tree error against the f32 step: spatial {e_sp:.3e}, unsharded "
        f"{e_un:.3e} (ratio {e_sp / e_un:.3f}, witness {TRAIN_WITNESS})")
    assert rel <= BF16_REL, f"{label}: the loss differs by {rel:.3e}"
    assert torch.equal(ma["target"], mb["target"]), f"{label}: the target histogram differs"
    assert e_sp <= TRAIN_WITNESS * e_un, f"{label}: gradient error {e_sp:.3e} against {e_un:.3e}"


def spatial_phase(cfg, batch, wrappers, smi):
    """Phase 18: spatial sharding on the card (see the module docstring)."""
    import torch.distributed as dist

    import pcf_torch.nn.fused as fused_mod
    from pcf_torch.entry import build, build_training
    from pcf_torch.parallel import mesh as mesh_mod
    from pcf_torch.parallel import spatial
    from pcf_torch.train import trainer
    from pcf_torch.train.checkpoint import CheckpointManager

    def launched():
        return {k: fn.launches for k, fn in wrappers.items()}

    plain = spatial._unwrap_windows(batch)
    valid = int(batch.masks[0].sum())
    root = tempfile.mkdtemp(prefix="chip_smoke_spatial_")
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    ref = {"evals": {}, "batch": batch.to("cpu")}
    want_logits = {}
    try:
        mesh = mesh_mod.make_mesh()
        for dtype_name in ("float32", "bfloat16"):
            cfg_s = cfg.copy()
            cfg_s.compute_dtype = dtype_name
            label = f"[spatial] {dtype_name}"
            # (a) eval: the captured spatial step on a 1-rank NCCL mesh against
            # the unsharded forward on the same plain-edge batch
            model = build(cfg_s, device="cuda", seed=0)
            with torch.no_grad():
                model.train()
                model.forward_batch(batch)  # BN calibration, as phase 3
                model.eval()
            ref["evals"][dtype_name] = (cfg_s, {k: v.cpu() for k, v in
                                                model.state_dict().items()})
            eager = mesh_mod.make_eager_eval_step(cfg_s)
            want, again = eager(model, plain), eager(model, plain)
            want_logits[dtype_name] = want.cpu()
            ev = spatial.make_spatial_eval_step(cfg_s, mesh)
            for fn in wrappers.values():
                fn.launches = 0
            got = ev(model, batch)
            torch.cuda.synchronize()
            counts = launched()
            rep = ev(model, batch)
            assert ev.graphs.captures == 1 and ev.graphs.replays == 1, (
                ev.graphs.captures, ev.graphs.replays)
            for k in ("pcf_conv_linear", "pconv_pe_conv_linear"):
                assert counts[k] > 0, f"{label}: {k} was not launched by the spatial eval step"
            for k in ("window_resolve", "window_scatter", "fused_layer_eval"):
                assert counts.get(k, 0) == 0, f"{label}: {k} launched on plain edges"
            scale = want.float().abs().max().item()
            for what, out in (("first call", got), ("replay", rep)):
                d = max_diff(out, want)
                log(f"{label}: spatial eval step ({what}) against the unsharded forward on "
                    f"plain edges: equal bit for bit: {torch.equal(out, want)}; max abs err "
                    f"{d:.3e}, eager against eager {max_diff(again, want):.3e} (logit scale "
                    f"{scale:.3e})")
                assert out.shape == want.shape, (out.shape, want.shape)
                assert d <= GRAPH_REL[dtype_name] * scale, f"{label}: eval {what} differs by {d:.3e}"
            log(f"{label}: spatial eval step launches (eager run and capture) {counts}")

            # (a) train: the captured spatial step against the unsharded
            # mesh=None step on the plain-edge batch. Their forwards are the
            # same bit for bit, but a gathered table's gradient reaches it
            # through one more autograd node (the all-gather's reduce-scatter)
            # and its parts are summed in another order. So, as phase 12
            # holds captured steps to eager ones: SGD, every ReLU and max
            # smooth, at spatial_held's tolerances (bf16 against an f32 step)
            cfg_t = cfg_s.copy()
            cfg_t.optimizer = "SGD"
            f32_grads = [None, None]
            if dtype_name == "bfloat16":
                cfg_f = cfg_t.copy()
                cfg_f.compute_dtype = "float32"
                state_f, _ = build_training(cfg_f, device="cuda", seed=0)
                eager_f = mesh_mod.make_eager_train_step(cfg_f)
                for i in range(2):
                    with smooth_kinks():
                        eager_f(state_f, plain, mesh_mod.step_seed(SPATIAL_SEED + i, 0))
                    f32_grads[i] = {k: q.grad.detach().double()
                                    for k, q in state_f.model.named_parameters()}
                del state_f, eager_f
            (sa, _), (sb, _) = (build_training(cfg_t.copy(), device="cuda", seed=0),
                                build_training(cfg_t.copy(), device="cuda", seed=0))
            step_sp = spatial.make_spatial_train_step(cfg_t, mesh)
            step_un = mesh_mod.make_train_step(cfg_t)
            recs = [EagerRecorder(fused_mod, "pcf_conv_linear"),
                    EagerRecorder(fused_mod, "pconv_pe_conv_linear")]
            for fn in wrappers.values():
                fn.launches = 0
            coll = CollectiveCounter()
            try:
                with smooth_kinks():
                    _, ma = step_sp(sa, batch, SPATIAL_SEED)
                    torch.cuda.synchronize()
            finally:
                coll.restore()
                for r in recs:
                    r.restore()
            counts = launched()
            for r in recs:
                # the first call runs the body eagerly, then captures it
                assert 2 * len(r.calls) == counts[r.name], (r.name, len(r.calls),
                                                            counts[r.name])
            for k in ("window_resolve", "window_scatter"):
                assert counts[k] == 0, f"{label}: {k} launched on plain edges"
            held = replay_against_plain(recs)
            with smooth_kinks():
                _, mb = step_un(sb, plain, mesh_mod.step_seed(SPATIAL_SEED, 0))
            spatial_held(f"{label} train first call", sa, ma, sb, mb, f32_grads[0])
            for fn in wrappers.values():
                fn.launches = 0
            with smooth_kinks():
                _, ma = step_sp(sa, batch, SPATIAL_SEED + 1)
                _, mb = step_un(sb, plain, mesh_mod.step_seed(SPATIAL_SEED + 1, 0))
            assert all(n == 0 for n in launched().values()), launched()
            spatial_held(f"{label} train replay", sa, ma, sb, mb, f32_grads[1])
            assert step_sp.graphs.captures == 1 and step_sp.graphs.replays == 1
            log(f"{label}: captured spatial train step (SGD, smooth) on a 1-rank NCCL mesh, "
                f"held to mesh=None on the plain-edge batch (first call and replay); eager "
                f"launches { {r.name: len(r.calls) for r in recs} } (as many captured), each "
                f"eager B and C call against its plain version: "
                f"{ {k: v for k, v in held.items() if v[0]} } (calls, max abs err); "
                f"{coll.summary()} a step")
            del sa, sb, step_sp, step_un, recs
            gc.collect()

            # the flagship step (AdamW, real kinks), the replays in turns:
            # spatial, unsharded on plain edges, windowed; each first call's
            # peak memory (its eager run and capture)
            states = {k: build_training(cfg_s.copy(), device="cuda", seed=0)[0]
                      for k in ("spatial", "plain", "windowed")}
            steps = {"spatial": spatial.make_spatial_train_step(cfg_s, mesh),
                     "plain": mesh_mod.make_train_step(cfg_s),
                     "windowed": mesh_mod.make_train_step(cfg_s)}
            feeds = {"spatial": batch, "plain": plain, "windowed": batch}
            peaks = {}
            for k, fn in steps.items():
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                fn(states[k], feeds[k], 0)
                torch.cuda.synchronize()
                peaks[k] = (torch.cuda.max_memory_allocated() - resident) / 2**20
            seeds = iter(range(100, 10 ** 6))
            times = timed_in_turns({k: functools.partial(
                lambda k: steps[k](states[k], feeds[k], next(seeds)), k) for k in steps},
                STEP_WARMUP, STEP_REPS)
            pools = {k: round(fn.graphs.pool_bytes() / 2**20, 1) for k, fn in steps.items()}
            ev_un, ev_win = mesh_mod.make_eval_step(cfg_s), mesh_mod.make_eval_step(cfg_s)
            ev_un(model, plain)
            ev_win(model, batch)
            etimes = timed_in_turns({"spatial": lambda: ev(model, batch),
                                     "plain": lambda: ev_un(model, plain),
                                     "windowed": lambda: ev_win(model, batch)},
                                    FWD_WARMUP, FWD_REPS)
            log(f"{label}: train replay ms (AdamW), {STEP_REPS} after {STEP_WARMUP} warm-up "
                f"in turns: {turns_summary(times, valid)}; first call's peak MiB above "
                f"resident { {k: round(v, 1) for k, v in peaks.items()} }; graph pools MiB "
                f"{pools}; eval replay ms, {FWD_REPS} after {FWD_WARMUP} in turns: "
                f"{turns_summary(etimes, valid)} ({smi})")
            del states, steps, ev, ev_un, ev_win, model
            gc.collect()
            torch.cuda.empty_cache()
        # the 2-rank train step's reference: the unsharded f32 step, smooth
        cfg_t = cfg.copy()
        cfg_t.compute_dtype = "float32"
        state, _ = build_training(cfg_t, device="cuda", seed=0)
        with smooth_kinks():
            _, m_ref = mesh_mod.make_eager_train_step(cfg_t)(
                state, plain, mesh_mod.step_seed(SPATIAL_SEED, 0))
        grads_ref = {k: q.grad.cpu().double() for k, q in state.model.named_parameters()}
        ref["train_cfg"] = cfg_t
        del state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) two gloo ranks on the one card, each a process: the eager steps
    t0 = time.perf_counter()
    torch.save(ref, os.path.join(root, "inputs.pt"))
    ranks = spatial_ranks(root, SPATIAL_RANKS)
    wall = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        for dtype_name, want in want_logits.items():
            got = out["logits"][dtype_name]
            scale = want.float().abs().max().item()
            d = max_diff(got, want)
            assert d <= GRAPH_REL[dtype_name] * scale, (
                f"[spatial] gloo rank {r} {dtype_name}: eval differs by {d:.3e}")
            log(f"[spatial] gloo rank {r} of {SPATIAL_RANKS} {dtype_name}: eval logits against "
                f"the unsharded forward max abs err {d:.3e} (logit scale {scale:.3e})")
        loss, want_loss = float(out["metrics"]["loss"]), float(m_ref["loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
        assert torch.equal(out["metrics"]["target"], m_ref["target"].cpu())
        over, worst, key = grad_ratios(out["grads"], grads_ref)
        assert over == 0, f"[spatial] gloo rank {r}: {over} gradients beyond tolerance ({key})"
        log(f"[spatial] gloo rank {r} of {SPATIAL_RANKS} float32 train step (smooth): loss "
            f"{loss:.6f} against {want_loss:.6f}, every gradient within tolerance (worst "
            f"{worst:.3f} of it, {key}), tree error {tree_error(out['grads'], grads_ref):.3e}")
    log(f"[spatial] {SPATIAL_RANKS} gloo ranks on cuda:0: {wall:.1f} s, start to end")

    # (c) trainer.main under spatial_train in a torchrun-style group of one
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
        synth_rooms(data, *MESH_ROOMS, ENTRY_ROOM_POINTS)
        cfg_h = phase13_config(data, exp)
        cfg_h.update(multi_host=True, spatial_train=True)
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = trainer.main(cfg_h)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launched()
        for k in ("pcf_conv_linear", "pconv_pe_conv_linear"):
            assert counts[k] > 0, f"[spatial] main: {k} was not launched"
        for k in ("window_resolve", "window_scatter", "fused_layer_eval"):
            assert counts.get(k, 0) == 0, f"[spatial] main: {k} launched on unwrapped edges"
        logtext = open(os.path.join(exp, "log.txt")).read()
        assert "rank 0 of 1" in logtext, "main did not join the group"
        lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
        losses = [r["train_loss"] for r in lines if "train_loss" in r]
        assert losses and all(math.isfinite(v) for v in losses), lines
        assert state.step == 2, state.step
        params, stats, epoch = CheckpointManager(os.path.join(exp, "model")).restore_eval()
        ckpt = {**params, **stats}
        for k, v in state.model.state_dict().items():
            assert torch.equal(v.cpu(), ckpt[k]), f"[spatial] main: checkpoint differs at {k}"
        log(f"[spatial] trainer.main, spatial_train in a 1-rank torchrun-style group (NCCL): "
            f"{state.step} steps in {wall:.1f} s, launches {counts}, train losses {losses}, "
            f"checkpoint of epoch {epoch} equal to main's state bit for bit")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


# phase 19: the shipped configurations that no chip run had run, in this
# order, each through the trainer's and eval.simple's CLIs at its published
# widths; one (CONFIG_MODULE_RUN) once more through `python -m
# pcf_torch.train.trainer` in a process of its own
CONFIG_NAMES = ("pcf_10cm", "pcf_pallas_10cm", "pcf_10cm_lite", "pcf_5cm", "pcf_2cm_ptf2")
CONFIG_MODULE_RUN = "pcf_10cm_lite"
# phase 19's depth: micro-steps per configuration (2 train steps at
# BATCH_SIZE 16 and 3; pcf_2cm_ptf2's accum_iter 5 at BATCH_SIZE 2: one
# optimizer update) and validation rooms, of phase 14's rooms
CONFIG_STEPS = {"pcf_2cm_ptf2": 5}
CONFIG_DEFAULT_STEPS, CONFIG_VAL_ROOMS = 2, 2


def room_subset(rooms: str, out: str, train: int, val: int) -> str:
    """out/train and out/val: links to the first `train` and `val` rooms of
    `rooms` (synth_rooms' layout). Returns out."""
    for split, n in (("train", train), ("val", val)):
        os.makedirs(os.path.join(out, split))
        files = sorted(glob.glob(os.path.join(rooms, split, "*.npz")))
        assert len(files) >= n, f"{len(files)} {split} rooms, {n} needed"
        for f in files[:n]:
            os.symlink(f, os.path.join(out, split, os.path.basename(f)))
    return out


def expected_launches(cfg) -> set:
    """The port kernels a phase 19 configuration's switches launch in its
    train and eval steps: B and C (plain edges: nei mode) where
    nn/fused.fused_wins holds, none where it does not. None of the
    configurations sets window_gather (A, D), fused_eval (E) or flat_geom
    (the flat resolve); a configuration that did would need its own set."""
    from pcf_torch.nn.fused import fused_wins

    assert not (cfg.window_gather or cfg.fused_eval or cfg.flat_geom), cfg.config
    return {"pcf_conv_linear", "pconv_pe_conv_linear"} if fused_wins(cfg) else set()


def configs_phase(wrappers, smi, device="cuda", rooms=None):
    """Phase 19: each of CONFIG_NAMES from pcf_torch/configs/<name>.json
    through the trainer's CLI (trainer.cli, the argv `python -m` passes) and
    eval.simple's (simple.cli), with --set overrides only for the data and
    experiment paths and total_epoches=1, eval_freq=1, save_freq=1: every
    width, BATCH_SIZE, bucket, mix3D, accum_iter, drop_path_rate and cap
    setting the configuration's own. Gated per configuration: finite losses;
    the checkpoint equal to main's final state bit for bit; accum_iter's
    optimizer steps; scene 0's logits of the evaluation on the card against
    the CPU port's forward on the same weights and batch (MODEL_TOL); the
    launches per kernel that the switches imply (expected_launches), every
    eager B and C call against its plain version; the card's memory
    reserved after it, cache emptied, within the graphs held and 1 GiB; no
    yaml imported. `rooms`: a directory of synth_rooms' rooms to link from
    (phase 14's), else made here. The entry points take their default
    device, the checks run on `device`."""
    from pcf_torch.config import load_config
    from pcf_torch.entry import build
    from pcf_torch.eval import simple
    from pcf_torch.train import trainer
    from pcf_torch.train.checkpoint import CheckpointManager

    t_phase = time.time()
    summary = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_configs_") as root:
        if rooms is None:
            rooms = os.path.join(root, "rooms")
            secs = synth_rooms(rooms, 16 * CONFIG_DEFAULT_STEPS, CONFIG_VAL_ROOMS)
            log(f"[configs] rooms written in {secs:.1f} s")

        def args_for(name, tag):
            cfg = load_config(shipped_config(name))
            n_train = CONFIG_STEPS.get(name, CONFIG_DEFAULT_STEPS) * cfg.BATCH_SIZE
            data = room_subset(rooms, os.path.join(root, f"data_{tag}"), n_train,
                               CONFIG_VAL_ROOMS)
            exp = os.path.join(root, f"exp_{tag}")
            sets = [*data_overrides(data, exp), f"eval_path={exp}/eval", "total_epoches=1",
                    "eval_freq=1", "save_freq=1"]
            argv = ["--config", shipped_config(name)] + [x for v in sets for x in ("--set", v)]
            return argv + ([] if device == "cuda" else ["--device", device]), exp, n_train

        rec = EntryRecorder(wrappers)
        try:
            for name in CONFIG_NAMES:
                argv, exp, n_train = args_for(name, name)
                cfg = trainer.parse_args(argv)[0]
                want = expected_launches(cfg)
                gc.collect()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                rec.zero()
                recs = eager_recorders() if want else []
                ends = len(rec.epoch_ends)
                t0 = time.perf_counter()
                state = trainer.cli(argv)
                torch.cuda.synchronize()
                main_s = time.perf_counter() - t0
                counts, captured = rec.counts(), dict(rec.in_capture)
                train_counts = counts
                train, val = rec.steps["train"][-1], rec.steps["eval"][-1]
                log(f"[configs] {name}: trainer.cli {main_s:.1f} s, {len(train.calls)} "
                    f"(micro-)steps at BATCH_SIZE {cfg.BATCH_SIZE}, accum_iter "
                    f"{cfg.accum_iter}; launches {launch_split(counts, captured)}")
                for k, n in counts.items():
                    assert (n > 0) == (k in want), (
                        f"[configs] {name}: {k} launched {n} times; the configuration's "
                        f"switches launch {sorted(want) or 'no port kernel'}")
                if recs:
                    held_to_plain("[configs]", f"{name} trainer.main", recs, counts, captured)
                    del recs
                    gc.collect()
                assert len(train.calls) == n_train // cfg.BATCH_SIZE, (
                    f"[configs] {name}: {len(train.calls)} steps for {n_train} rooms")
                lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
                losses = [r["train_loss"] for r in lines if "train_loss" in r]
                assert losses and all(math.isfinite(v) for v in losses), losses
                ck = CheckpointManager(os.path.join(exp, "model"))
                params, stats, epoch = ck.restore_eval()
                saved = {**params, **stats}
                for k, v in state.model.state_dict().items():
                    assert torch.equal(v.cpu(), saved[k]), f"[configs] {name}: checkpoint at {k}"
                opt = torch.load(ck._path(epoch), map_location="cpu",
                                 weights_only=True)["optimizer"]
                inner_steps = {int(v["step"]) for v in opt["inner"]["state"].values()}
                assert opt["count"] == len(train.calls) and inner_steps == {
                    len(train.calls) // cfg.accum_iter}, (
                    f"[configs] {name}: {opt['count']} updates, inner optimizer steps "
                    f"{inner_steps}, for {len(train.calls)} micro-steps at accum_iter "
                    f"{cfg.accum_iter}")
                calls, end = train.calls, rec.epoch_ends[ends]
                first_s = calls[0]["ms"] / 1e3
                s_it = ((end - calls[1]["start"]) / (len(calls) - 1) if len(calls) > 1
                        else None)
                peak = torch.cuda.max_memory_allocated()
                log(f"[configs] {name}: losses {losses}, checkpoint of epoch {epoch} equal to "
                    f"main's final state bit for bit; optimizer: {opt['count']} updates, "
                    f"{inner_steps} inner steps; first step (eager run and capture) "
                    f"{first_s:.3f} s" + ("" if s_it is None else
                                         f", {s_it:.4f} s/it over steps 2-{len(calls)}")
                    + f"; train graphs: {graph_pools(train)}; peak memory "
                    f"{peak / 2**30:.2f} GiB")
                del state, train, val
                for steps in rec.steps.values():
                    steps.clear()
                gc.collect()

                # -- eval.simple's CLI on the checkpoint ----------------------
                rec.zero()
                recs = eager_recorders() if want else []
                t0 = time.perf_counter()
                miou, mean_s = simple.cli(argv + ["--pretrain_path", os.path.join(exp, "model")])
                eval_s = time.perf_counter() - t0
                counts, captured = rec.counts(), dict(rec.in_capture)
                for k, n in counts.items():
                    assert (n > 0) == (k in want), (
                        f"[configs] {name} evaluate: {k} launched {n} times")
                if recs:
                    held_to_plain("[configs]", f"{name} evaluate", recs, counts, captured)
                    del recs
                ev = rec.steps["eval"][-1]
                assert len(ev.calls) == 2 * CONFIG_VAL_ROOMS, len(ev.calls)
                assert 0.0 <= miou <= 1.0 and math.isfinite(mean_s), (miou, mean_s)
                model = ev.calls[0]["model"]
                model_cpu = build(model.cfg, device="cpu")
                model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
                batch = ev.calls[1]["batch"]
                with torch.no_grad():
                    want_l = model_cpu.forward_batch(batch.to("cpu"))
                m0 = batch.masks[0].cpu()
                got = ev.calls[1]["logits"].cpu()
                diff = max_diff(got[m0], want_l[m0])
                assert torch.allclose(got[m0], want_l[m0], **MODEL_TOL), (
                    f"[configs] {name} evaluate scene 0: logits on the card {diff:.3e} from "
                    f"the CPU's")
                pool = ev.graphs.pool_bytes()
                log(f"[configs] {name}: eval.simple.cli {eval_s:.1f} s (evaluate's mean "
                    f"{mean_s * 1e3:.3f} ms a scene, replay ms "
                    f"{[round(c['ms'], 3) for c in ev.calls[1::2]]}), launches "
                    f"{launch_split(counts, captured)}; mIoU {miou:.4f}; scene 0's logits "
                    f"against the CPU port (same weights and batch): max abs err {diff:.3e} "
                    f"(scale {want_l[m0].abs().max().item():.3e}, MODEL_TOL); eval graphs: "
                    f"{graph_pools(ev)}")
                del model, model_cpu, ev, batch, got, want_l
                for steps in rec.steps.values():
                    steps.clear()
                gc.collect()
                torch.cuda.empty_cache()
                grown = torch.cuda.memory_reserved() - reserved
                assert grown <= 2**30, (
                    f"[configs] {name}: {grown / 2**20:.1f} MiB of the card's memory still "
                    f"reserved after the run, no graph held")
                summary[name] = dict(main_s=round(main_s, 1), eval_s=round(eval_s, 1),
                                     first_step_s=first_s, s_it=s_it, steps=len(calls),
                                     launches={KERNEL_LETTERS[k]: (train_counts[k], counts[k])
                                               for k in sorted(want)},
                                     peak_gib=round(peak / 2**30, 2), eval_pool_mib=pool / 2**20,
                                     miou=miou, reserved_after_mib=grown / 2**20)
                log(f"[configs] {name} ({smi}): {json.dumps(summary[name])}")
        finally:
            rec.restore()

        # -- the module entry: python -m pcf_torch.train.trainer ------------
        argv, exp, n_train = args_for(CONFIG_MODULE_RUN, "module")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pcf_torch.train.trainer", *argv], cwd=HERE,
                           capture_output=True, text=True)
        module_s = time.perf_counter() - t0
        assert r.returncode == 0, (
            f"[configs] python -m pcf_torch.train.trainer --config {CONFIG_MODULE_RUN}.json "
            f"exited {r.returncode}:\n{r.stderr[-4000:]}")
        lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
        losses = [x["train_loss"] for x in lines if "train_loss" in x]
        assert losses and all(math.isfinite(v) for v in losses), losses
        params, stats, epoch = CheckpointManager(os.path.join(exp, "model")).restore_eval()
        assert epoch == 1 and all(torch.isfinite(v).all() for v in params.values())
        log(f"[configs] python -m pcf_torch.train.trainer --config "
            f"pcf_torch/configs/{CONFIG_MODULE_RUN}.json (and the --set overrides) in a process "
            f"of its own: {module_s:.1f} s, exit 0, losses {losses}, a finite checkpoint of "
            f"epoch 1")
    assert "yaml" not in sys.modules, "phase 19 imported yaml"
    log(f"[configs] summary ({smi}; launches: trainer.main, evaluate): {json.dumps(summary)}; "
        f"no yaml imported; phase 19 "
        f"{time.time() - t_phase:.1f} s")


def conv_times(model, batch, summary):
    """Phase 14: B's and C's calls of one eval forward of the trained model
    on a device-pyramid batch (plain edges), each against its plain version,
    timed beside its plain version and bound (phase 4's way)."""
    import pcf_torch.nn.fused as fused_mod
    from pcf_torch.ops.kernels.pconv_fused import (
        pconv_pe_conv_linear, pconv_pe_conv_linear_plain, pcf_conv_linear,
        pcf_conv_linear_plain)

    pairs = {"pcf_conv_linear": (pcf_conv_linear, pcf_conv_linear_plain),
             "pconv_pe_conv_linear": (pconv_pe_conv_linear, pconv_pe_conv_linear_plain)}
    recs = [Recorder(fused_mod, k) for k in pairs]
    model.eval()
    with torch.no_grad():
        model.forward_batch(batch)
    for r in recs:
        r.restore()
    out = {}
    with torch.no_grad():
        for r in recs:
            kern, plain = pairs[r.name]
            rows_of = valid_rows([dict(batch=batch, launches={r.name: len(r.calls)},
                                       captured={r.name: 0})])
            err = max(check_call(r.name, kern, plain, a, rows=rows_of(r.name, i, a))
                      for i, a in enumerate(r.calls))
            ms = cuda_ms(lambda: [kern(*a) for a in r.calls])
            plain_ms = cuda_ms(lambda: [plain(*a) for a in r.calls], reps=3)
            tot = [conv_cost(r.name, a) for a in r.calls]
            b_ms = sum(b for b, _ in tot) / PEAK_BYTES * 1e3
            o_ms = sum(o for _, o in tot) / PEAK_OPS[torch.float32] * 1e3
            out[r.name] = dict(calls=len(r.calls), ms=ms, plain_ms=plain_ms,
                               bound_ms=max(b_ms, o_ms),
                               bound_by="bytes" if b_ms >= o_ms else "operations",
                               max_abs_err=err)
            log(f"[pyramid] {r.name} float32 nei mode, one eval forward at "
                f"{batch.points[0].shape[0]} level-0 rows: {len(r.calls)} calls, max abs err "
                f"{err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{max(b_ms, o_ms):.4f} ms by {out[r.name]['bound_by']}")
    summary["conv"] = out


def main() -> int:
    faulthandler.enable()
    if len(sys.argv) > 1 and sys.argv[1] == "--spatial-rank":
        return spatial_rank(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    import pcf_torch.nn.fused as fused_mod
    import pcf_torch.nn.fused_eval as fused_eval_mod
    import pcf_torch.ops.kernels.pconv_fused as pconv_mod
    import pcf_torch.ops.kernels.window_resolve as resolve_mod
    import pcf_torch.ops.window as window_mod
    import pcf_torch.parallel.mesh as mesh_mod
    from pcf_torch.entry import build, build_training, flagship_batch
    from pcf_torch.nn.layers import PCFLayer, PointConv, PointConvStridePE, PointConvTransposePE
    from pcf_torch.ops.kernels import build as kbuild
    from pcf_torch.ops.kernels.knn_scene import knn_scene
    from pcf_torch.ops.kernels.layer_eval import (fused_layer_eval, fused_layer_eval_plain,
                                                  launch_shape as layer_eval_shape)
    from pcf_torch.ops.kernels.pconv_fused import (
        launch_shape, pconv_pe_conv_linear, pconv_pe_conv_linear_plain, pcf_conv_linear,
        pcf_conv_linear_plain)
    from pcf_torch.ops.kernels.window_resolve import (plan_for,
                                                      window_resolve, window_resolve_flat,
                                                      window_resolve_plain,
                                                      windowed_take_flat_plain)
    from pcf_torch.ops.kernels.window_scatter import (piece_len, window_scatter,
                                                      window_scatter_inverse, window_scatter_plain)
    from pcf_torch.ops.window import WindowedEdges
    from pcf_torch.parallel.mesh import make_eager_train_step
    from pcf_torch.train.loss import cross_entropy_loss

    t_start = time.time()
    lap = [t_start]

    def phase_time(n):
        """[time] phase n: the seconds since the last phase ended."""
        now = time.time()
        log(f"[time] phase {n}: {now - lap[0]:.1f} s")
        lap[0] = now

    # ---- 1 device -------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    phase_time(1)

    # ---- 2 build --------------------------------------------------------
    t0 = time.time()
    reports = kbuild.build()  # prints each source's seconds
    log(f"[build] nvcc {' '.join(kbuild.NVCC_FLAGS)}, translation units where split "
        f"{kbuild.PARTS}: {time.time() - t0:.1f} s")
    for src, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                log(f"[build] {src}: {line.strip()}")
    phase_time(2)

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
    eager_launches = {}  # eager launch counts per path and dtype, for phase 12
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
        eager_launches[("standard", dtype_name)] = launches
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
    # the kernels run through torch custom operators (pcf_torch/serve exports
    # them): the host's extra time per call, through the operator against the
    # launch it wraps, on one small call of kernel A, both timed in turns
    e = runs["float32"]["calls"]["window_resolve"][0]
    small = (e[0], e[1][:1].contiguous(), e[2][:1].contiguous())
    direct = functools.partial(resolve_mod._launch, *small)
    via_op = functools.partial(resolve_mod.resolve_op, *small)
    per_call = {k: statistics.median(t) / DISPATCH_CALLS for k, t in timed_in_turns(
        {k: functools.partial(lambda f: [f() for _ in range(DISPATCH_CALLS)], f)
         for k, f in (("op", via_op), ("launch", direct))}, 2, 10).items()}
    extra_us = (per_call["op"] - per_call["launch"]) * 1e3
    n_calls = {d: sum(r["launches"].values()) for d, r in runs.items()}
    log(f"[slice] custom-operator dispatch: {per_call['op'] * 1e3:.2f} us a call through the "
        f"operator, {per_call['launch'] * 1e3:.2f} us for the launch alone: "
        f"{extra_us:.2f} us more a call; "
        + ", ".join(f"{d} {n} calls a forward, {n * extra_us / 1e3:.3f} ms of its eager median"
                    for d, n in n_calls.items()))
    phase_time(3)

    # ---- 4 kernels ------------------------------------------------------
    def bytes_ops(kname, args):
        if kname == "window_resolve":
            table, wr, lt = args
            out = lt.numel() * table.shape[1] * table.element_size()
            return table.numel() * table.element_size() + (wr.numel() + lt.numel()) * 4 + out, 0
        return conv_cost(kname, args)

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

    baseline = None
    if "--resolve-baseline" in sys.argv:
        baseline = baseline_resolve(sys.argv[sys.argv.index("--resolve-baseline") + 1])

    def against_baseline(calls) -> str:
        """The baseline's and this kernel's ms over `calls`, each the mean
        of two timings in the order old, new, new, old, and zero_'s."""
        fns = (lambda: [baseline(*a) for a in calls], lambda: [window_resolve(*a) for a in calls])
        t = [cuda_ms(fns[k]) for k in (0, 1, 1, 0)]
        outs = [torch.empty((wr.shape[0], lt.shape[-1], table.shape[1]), dtype=table.dtype,
                            device=table.device) for table, wr, lt in calls]
        zero_ms = cuda_ms(lambda: [o.zero_() for o in outs])
        return (f"; in turns: baseline {(t[0] + t[3]) / 2:.4f} ms, this design "
                f"{(t[1] + t[2]) / 2:.4f} ms, zero_ {zero_ms:.4f} ms")

    def resolve_shapes(dtype_name, calls):
        """Kernel A's launch plan, calls, time and bound per call shape."""
        shapes = {}
        for a in calls:
            table, wr, lt = a
            key = (str(table.dtype).split(".")[-1], table.shape[1], wr.shape[0],
                   lt.shape[-1], wr.shape[1])
            shapes.setdefault(key, []).append(a)
        with torch.no_grad():
            for (tdt, C, T, MtK, Wsz), same in sorted(shapes.items()):
                table = same[0][0]
                row_bytes = C * table.element_size()
                plan = plan_for(*same[0])
                shape_ms = cuda_ms(lambda: [window_resolve(*a) for a in same])
                b_ms = bound("window_resolve", same, table.dtype)[0]
                log(f"[kernels] window_resolve {dtype_name} table {tdt} C={C} ({row_bytes}-byte "
                    f"rows) edges {T * MtK} (T={T} x {MtK}) Wsz={Wsz}: {plan['route']} route, "
                    f"{plan['unit']}-byte units, {plan['lanes']} lanes per edge, grid "
                    f"{plan['grid']} of {plan['threads']} threads, {plan['edges_per_block']} "
                    f"edges a block, {plan['smem'] / 1024:.1f} KiB shared memory; "
                    f"{len(same)} calls, {shape_ms:.4f} ms, bound {b_ms:.4f} ms"
                    + ("" if baseline is None else against_baseline(same)))

    results = {}
    for dtype_name, run in runs.items():
        dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        for kname, calls in run["calls"].items():
            kern, plain = kernels[kname], plains[kname]
            if kname == "window_resolve":
                resolve_shapes(dtype_name, calls)
            else:
                # B: E is the guidance's heads; C: the PE width P
                shapes = sorted({(a[0].shape[1], 0 if a[2] is None else a[2].shape[-1],
                                  a[3].shape[2], a[3].shape[1], a[4].shape[1], a[3].shape[0])
                                 for a in calls})
                for C, E, W, K, O, M in shapes:
                    pe = kname == "pconv_pe_conv_linear"
                    sh = launch_shape(C, K, W, O, M, bf16=dt == torch.bfloat16,
                                      P=E if pe else 0)
                    same = [a for a in calls if a[3].shape[0] == M and a[4].shape[1] == O
                            and a[0].shape[1] == C and a[3].shape[2] == W]
                    with torch.no_grad():
                        shape_ms = cuda_ms(lambda: [kern(*a) for a in same])
                    log(f"[kernels] {kname} {dtype_name} C={C} {'P' if pe else 'H'}={E} W={W} "
                        f"K={K} O={O} M={M}: {sh['points']} points per block, "
                        f"{sh['o_slices']} O slice(s) of {sh['o_per_slice']}, "
                        f"{sh['c_splits']} channel range(s), grid {sh['blocks']} blocks of "
                        f"{sh['threads']} threads, {sh['smem'] / 1024:.1f} KiB dynamic shared "
                        f"memory, contraction on {sh['contraction']}, projection on "
                        f"{sh['projection']}; {len(same)} calls, {shape_ms:.3f} ms")
            # the main path's calls first: the JSON line reports them
            modes = {"window": calls}
            if kname != "window_resolve":
                modes["nei"] = [nei_mode(a) for a in calls]
            for mode, cl in modes.items():
                err = 0.0
                with torch.no_grad():
                    for args in cl:
                        err = max(err, check_call(kname, kern, plain, args,
                                                  label=f"{kname} {dtype_name} {mode}"))
                        if kname != "window_resolve":
                            assert torch.equal(kern(*args), kern(*args)), (
                                f"{kname} {dtype_name} {mode}: two launches on the same "
                                f"inputs differ")
                        if kname == "window_resolve" and baseline is not None:
                            assert torch.equal(baseline(*args), plain(*args)), (
                                "baseline window_resolve not bit-exact")
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
                    f"forward"
                    + ("" if kname == "window_resolve" else
                       ", two launches of each equal bit for bit")
                    + f", max abs err {err:.3e}, kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, library "
                    f"{'-' if lib_ms is None else f'{lib_ms:.3f}'} ms, bound {b_ms:.4f} ms "
                    f"by {b_by} ({tot_b / 1e6:.1f} MB, {tot_o / 1e9:.2f} GOP)"
                    + ("" if baseline is None or kname != "window_resolve"
                       else against_baseline(cl)))
    del runs
    phase_time(4)

    # ---- 5 model: card against CPU ---------------------------------------
    # phase 3's configuration, and pcf_torch.bench's (the contraction in
    # ops/pconv.py, kernel A its only kernel)
    cfg_s, batch_s = flagship_batch(level0_points=4000, bucket=1024, window_gather=True,
                                    device="cuda")
    m = batch_s.masks[0].cpu()
    cfg_bench = cfg_s.copy()
    cfg_s.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
    for label, cfg_m in (("", cfg_s), (", bench configuration", cfg_bench)):
        gpu_model = build(cfg_m, device="cuda", seed=1)
        with torch.no_grad():
            gpu_model.train()
            gpu_model.forward_batch(batch_s)
            gpu_model.eval()
            got = gpu_model.forward_batch(batch_s).cpu()
            cpu_model = build(cfg_m, device="cpu", seed=1)
            cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
            want = cpu_model.forward_batch(batch_s.to("cpu"))
        err = (got[m] - want[m]).abs().max().item()
        log(f"[model] entry size, f32{label}, card vs CPU plain: max abs err {err:.3e} "
            f"(logit scale {want[m].abs().max().item():.3e})")
        assert torch.allclose(got[m], want[m], **MODEL_TOL), f"model logits differ: {err:.3e}"
    phase_time(5)

    # ---- 6 train ---------------------------------------------------------
    all_kernels = dict(kernels, window_scatter=window_scatter)
    states, train_runs = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        cfg_d = cfg.copy()
        cfg_d.compute_dtype = dtype_name
        # the eager body: its launches are counted, and its times stay
        # comparable with earlier runs; phase 12 times the captured step
        states[dtype_name] = (build_training(cfg_d, device="cuda", seed=0)[0],
                              make_eager_train_step(cfg_d))
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
                # A's callers: the gathers of the forward and of B's and
                # C's backward
                recs_a = [Recorder(window_mod, "window_resolve"),
                          Recorder(pconv_mod, "window_resolve")]
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
                for r in recs_a:
                    r.restore()
                mesh_mod.cross_entropy_loss = real_loss
                for k, n in launches.items():
                    assert n > 0, f"{k} was not launched by the train step"
                assert launches["window_scatter"] == expected[0], (
                    f"window_scatter launched {launches['window_scatter']} times, the "
                    f"step's graph holds {expected[0]} resolves that need a gradient")
                log(f"[train] {dtype_name}: launches per train step {launches} "
                    f"(window_scatter expected {expected[0]})")
                resolves = [a for r in recs_a for a in r.calls]
                assert len(resolves) == launches["window_resolve"], (
                    f"{len(resolves)} window_resolve calls recorded, "
                    f"{launches['window_resolve']} launched")
                eager_launches[("train", dtype_name)] = launches
                train_runs[dtype_name] = dict(launches=launches, calls=rec.calls,
                                              resolves=resolves)
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
    for dtype_name, run in train_runs.items():
        calls = run.pop("resolves")
        with torch.no_grad():
            for a in calls:
                assert torch.equal(window_resolve(*a), window_resolve_plain(*a)), (
                    f"window_resolve {dtype_name} train step: not bit-exact")
            ms = cuda_ms(lambda: [window_resolve(*a) for a in calls])
        b_ms, _, tot_b, _ = bound("window_resolve", calls,
                                  torch.float32 if dtype_name == "float32" else torch.bfloat16)
        log(f"[train] window_resolve {dtype_name}: {len(calls)} calls per train step, "
            f"bit-exact, kernel {ms:.3f} ms, bound {b_ms:.4f} ms by bytes "
            f"({tot_b / 1e6:.1f} MB)")
    del calls
    phase_time(6)

    # ---- 7 scatter: kernel D against its plain version --------------------
    for dtype_name, run in train_runs.items():
        calls = run["calls"]
        err = 0.0
        with torch.no_grad():
            for args in calls:
                err = max(err, check_call("window_scatter", window_scatter, window_scatter_plain,
                                          args, label=f"window_scatter {dtype_name}"))
                assert torch.equal(window_scatter(*args), window_scatter(*args)), (
                    f"window_scatter {dtype_name}: two launches on the same inputs differ")
            log(f"[scatter] window_scatter {dtype_name}: two launches on the same inputs "
                f"equal bit for bit in all {len(calls)} calls")
            unshared_ms = cuda_ms(lambda: [window_scatter(*a) for a in calls])
            ms = cuda_ms(lambda: shared_calls(window_scatter, calls))
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
        # how much of the step's fan-in the heavy rows hold: rows of more
        # edges than a piece, summed piece by piece
        over = heavy = 0
        for _, wr, lt, n, _ in calls:
            rows = torch.gather(wr, 1, lt[:, 0].long().clamp(0, wr.shape[1] - 1)).reshape(-1)
            counts = torch.bincount(rows[(rows >= 0) & (rows < n)], minlength=n)
            cap = piece_len(n, rows.numel())
            over += int(counts[counts > cap].sum())
            heavy += int((counts > cap).sum())
        log(f"[scatter] window_scatter {dtype_name}: {sum(a[2].numel() for a in calls)} edges "
            f"per step, {over} of them in {heavy} heavy rows (summed in pieces)")
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
            f"max abs err {err:.3e}, kernel {ms:.3f} ms as the step runs them (one inverse "
            f"per edge set, shared_inverses), {unshared_ms:.3f} ms each call alone (of which "
            f"the inverses {inverse_ms:.3f} ms), plain {plain_ms:.3f} ms, "
            f"index_add_ {lib_ms:.3f} ms, bound {b_ms:.4f} ms by bytes "
            f"({tot_b / 1e6:.1f} MB)")
    del train_runs, run, calls
    phase_time(7)

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
    phase_time(8)

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
        eager_launches[("fused_eval", dtype_name)] = launches
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
    phase_time(9)

    # ---- 10 layer: kernel E against its plain version ---------------------
    for dtype_name, run in fused_runs.items():
        dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        calls = run["calls"]
        shapes = {}
        for args, kw in calls:
            key = (tuple(args[0].shape), tuple(args[2].nei.shape), tuple(args[8].shape),
                   kw.get("strided", False))
            shapes.setdefault(key, []).append((args, kw))
        with torch.no_grad():
            for key, same in shapes.items():
                sh = layer_eval_shape(*same[0][0], **same[0][1])
                shape_ms = cuda_ms(lambda: [fused_layer_eval(*a, **k) for a, k in same])
                log(f"[layer] {dtype_name} table {key[0]} edges {key[1]} linear {key[2]} "
                    f"strided={key[3]}: {sh['points']} points per block, {sh['o_slices']} O "
                    f"slice(s) of {sh['o_per_slice']}, {sh['c_splits']} channel range(s), "
                    f"grid {sh['blocks']} blocks of {sh['threads']} threads, "
                    f"{sh['smem'] / 1024:.1f} KiB dynamic shared memory, per-edge stage "
                    f"{sh['edge_chunk_points']} points at a time, workspace "
                    f"{sh['workspace'] / 2**20:.2f} MiB; MLPs on {sh['mlps']}, contraction "
                    f"on {sh['contraction']}, projection on {sh['projection']}; {len(same)} "
                    f"calls, {shape_ms:.3f} ms")
        err = 0.0
        with torch.no_grad():
            for args, kw in calls:
                err = max(err, check_call("fused_layer_eval", fused_layer_eval,
                                          fused_layer_eval_plain, args, kw,
                                          label=f"fused_layer_eval {dtype_name}"))
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
    phase_time(10)

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
        eager_launches[("flat_geom", "float32")] = launches
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
    del model, logits, standard, rec
    phase_time(11)

    # ---- 12 graphs: the captured steps ------------------------------------
    _, batch2 = flagship_batch(level0_points=20000, bucket=4096, n_scenes=2,
                               window_gather=True, device="cuda", seed=2,
                               level_caps=[p.shape[0] for p in batch.points])
    assert batch2.signature() == batch.signature()
    graphs_phase(cfg, batch, batch2, models, eager_launches, valid)
    del models, batch2
    bench_phase()
    phase_time(12)

    every = dict(all_kernels, window_resolve_flat=window_resolve_flat,
                 fused_layer_eval=fused_layer_eval, knn_scene=knn_scene)
    kept = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    rooms = tempfile.mkdtemp(prefix="chip_smoke_rooms_")
    started = None
    try:
        # ---- 13 entry: the user's entry points ----------------------------
        gc.collect()
        torch.cuda.empty_cache()
        entry_phase(every, smi, keep_checkpoint=os.path.join(kept, "model"))
        # phase 15's exports, from phase 13's checkpoint, run beside phase 14
        started = serve_start(os.path.join(kept, "model"))
        phase_time(13)

        # ---- 14 pyramid: the device pyramid and voting --------------------
        gc.collect()
        torch.cuda.empty_cache()
        secs = synth_rooms(rooms, PYRAMID_TRAIN_ROOMS, PYRAMID_VAL_ROOMS)
        log(f"[pyramid] {PYRAMID_TRAIN_ROOMS} + {PYRAMID_VAL_ROOMS} synthetic rooms written in "
            f"{secs:.1f} s (phases 14 and 19 read them)")
        results[("knn_scene", "float32")] = pyramid_phase(every, smi, rooms=rooms)
        phase_time(14)

        # ---- 15 serve: export, the serving CLI, the exported programs ------
        gc.collect()
        torch.cuda.empty_cache()
        serve_phase(every, smi, started=started)
        started = None
        phase_time(15)

        # ---- 16 mesh: data-parallel training on a 1-rank NCCL group --------
        gc.collect()
        torch.cuda.empty_cache()
        mesh_phase(cfg, batch, all_kernels, smi)
        phase_time(16)

        # ---- 17 variants: the off-default model keys and classification ----
        gc.collect()
        torch.cuda.empty_cache()
        variants_phase(all_kernels, smi)
        phase_time(17)

        # ---- 18 spatial: one batch's points sharded over the ranks ---------
        gc.collect()
        torch.cuda.empty_cache()
        spatial_phase(cfg, batch, all_kernels, smi)
        phase_time(18)

        # ---- 19 configs: the shipped configurations through the CLIs -------
        gc.collect()
        torch.cuda.empty_cache()
        configs_phase(every, smi, rooms=rooms)
        phase_time(19)
    finally:
        if started is not None:  # a phase before 15 failed: stop the exports
            for proc in started["procs"].values():
                proc.kill()
                proc.wait()
            shutil.rmtree(started["root"], ignore_errors=True)
        shutil.rmtree(kept, ignore_errors=True)
        shutil.rmtree(rooms, ignore_errors=True)

    log(f"[done] {time.time() - t_start:.1f} s")
    # the flat resolve reads geometry, f32 in either dtype, and the kNN
    # kernel points: their float32 rows stand in both lines
    order = list(all_kernels) + ["window_resolve_flat", "fused_layer_eval", "knn_scene"]
    dtypes = {"window_resolve_flat": "float32", "knn_scene": "float32"}
    log("[kernels float32] " + json.dumps([results[(k, "float32")] for k in order]))
    log(smi)
    print(json.dumps({"kernels": [results[(k, dtypes.get(k, "bfloat16"))] for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
