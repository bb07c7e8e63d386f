"""Each CUDA kernel against its plain PyTorch version, on the card.

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the `cuda` fixture decides, at run time).
Tolerances are chip_smoke.py's: the resolve and the flat resolve
bit-exact; the fused kernels and the whole-layer kernel within 1e-4 in f32
and 1e-2 of the output scale in bf16 (a partial rounded to bf16 after an f32
sum in another order may move one bf16 step), the whole-layer kernel's
max-pool shortcut exact; the window scatter within 1e-5 of the output's
scale in f32 (its atomics sum in another order) and one bf16 step in bf16.
"""

import os

import numpy as np
import pytest
import torch

from pcf_torch.ops.kernels.pconv_fused import (launch_shape, pconv_pe_conv_linear,
                                               pconv_pe_conv_linear_plain,
                                               pcf_conv_linear, pcf_conv_linear_plain)
from pcf_torch.ops.kernels.layer_eval import (fused_layer_eval, fused_layer_eval_plain,
                                              launch_shape as layer_eval_shape)
from pcf_torch.ops.kernels.window_resolve import (window_resolve, window_resolve_flat,
                                                  window_resolve_plain, windowed_take_flat_plain)
from pcf_torch.ops.kernels.window_scatter import window_scatter, window_scatter_plain
from pcf_torch.ops.window import build_windows

pytestmark = pytest.mark.gpu

N, M, K, TILE, WIN = 5000, 4096, 16, 128, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edges(cuda, seed=0, out_of_range=True):
    """Neighbourhoods of Morton-like locality: tile rows draw from a band of
    the table, so each tile's unique rows fit the window."""
    rng = np.random.default_rng(seed)
    base = (np.arange(M) * (N - 400) // M)[:, None]
    nei = (base + rng.integers(0, 400, size=(M, K))).astype(np.int32)
    if out_of_range:
        nei[-1, :2] = [N + 7, -1]  # clamped, as jnp.take(mode="clip")
    return build_windows(nei, tile=TILE, window=WIN).to(cuda)


def _check(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, atol=1e-2 * scale, rtol=1e-2)


def _one_tile(cuda, seed=0):
    """A single 128-point tile (T = 1) over a window of 1280 rows, with
    _edges' out-of-range indices."""
    rng = np.random.default_rng(seed)
    nei = (1000 + rng.integers(0, 1200, size=(TILE, K))).astype(np.int32)
    nei[-1, :2] = [N + 7, -1]
    return build_windows(nei, tile=TILE, window=1280).to(cuda)


# C = 1 and 2 reach 2- and 4-byte rows in bf16; 8 rows of 16 and 32
# bytes (one and two lanes an edge); 64, 256 and 512 rows wider than one
# 32-lane group (in f32; 512 in bf16 too)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 6, 8, 32, 64, 96, 256, 512])
@pytest.mark.parametrize("tiles", ["many", "one"])
def test_window_resolve_bit_exact(cuda, dtype, C, tiles):
    e = _edges(cuda) if tiles == "many" else _one_tile(cuda)
    table = torch.randn(N, C, device=cuda).to(dtype)
    n = window_resolve.launches
    got = window_resolve(table, e.window_rows, e.localT)
    assert window_resolve.launches == n + 1
    assert torch.equal(got, window_resolve_plain(table, e.window_rows, e.localT))
    M_ = e.nei.shape[0]
    assert torch.equal(got.reshape(M_, K, C), table[e.nei.long().clamp(0, N - 1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 5, 6, 8])
def test_window_resolve_ragged_tiles(cuda, dtype, C):
    """Tiles of 98 edges, not a multiple of 4 or 16: blocks whose slots are
    loaded one by one and whose output starts and ends off a 16-byte
    boundary; slots and window rows out of range on both sides."""
    g = torch.Generator().manual_seed(7)
    T, MtK, Wsz = 3, 98, 64
    wr = torch.randint(-2, N + 2, (T, Wsz), generator=g, dtype=torch.int32).to(cuda)
    lt = torch.randint(-1, Wsz + 1, (T, 1, MtK), generator=g, dtype=torch.int32).to(cuda)
    table = torch.randn(N, C, device=cuda).to(dtype)
    assert torch.equal(window_resolve(table, wr, lt), window_resolve_plain(table, wr, lt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,offset", [(3, 3), (6, 6), (102, 102), (32, 1), (64, 3), (96, 96)])
def test_window_resolve_misaligned_table(cuda, dtype, C, offset):
    """A table that is a view `offset` elements into its storage (one row
    in where C = offset): an alignment below 16 bytes sends every width to
    the narrow route in smaller units (a row offset keeps 96-channel rows
    aligned, and wide), bit-exact all the same."""
    e = _edges(cuda, 5)
    table = torch.randn(N * C + offset, device=cuda).to(dtype)[offset:].view(N, C)
    assert table.data_ptr() % 16 != 0 or C * table.element_size() % 16 == 0
    got = window_resolve(table, e.window_rows, e.localT)
    assert torch.equal(got, window_resolve_plain(table, e.window_rows, e.localT))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
@pytest.mark.parametrize("C,H,W,O", [(32, 8, 16, 64), (80, 8, 16, 160), (12, 4, 1, 24)])
def test_pcf_conv_linear(cuda, dtype, windowed, C, H, W, O):
    e = _edges(cuda, 1)
    g = torch.Generator(device=cuda).manual_seed(0)
    feats = torch.randn(N, C, device=cuda, generator=g).to(dtype)
    guid = torch.rand(M, K, H, device=cuda, generator=g).to(dtype)
    v = torch.randn(M, K, W, device=cuda, generator=g).to(dtype)
    lw = torch.randn(C * W, O, device=cuda, generator=g) / (C * W) ** 0.5
    lb = torch.randn(O, device=cuda, generator=g)
    edges = e if windowed else e.nei
    n = pcf_conv_linear.launches
    got = pcf_conv_linear(feats, edges, guid, v, lw, lb)
    assert pcf_conv_linear.launches == n + 1
    _check(got, pcf_conv_linear_plain(feats, edges, guid, v, lw, lb), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
@pytest.mark.parametrize("C,P,W,O", [(6, 12, 16, 64), (16, 16, 16, 32), (320, 32, 1, 256),
                                     (8, 0, 4, 16)])
def test_pconv_pe_conv_linear(cuda, dtype, windowed, C, P, W, O):
    e = _edges(cuda, 2)
    g = torch.Generator(device=cuda).manual_seed(1)
    feats = torch.randn(N, C, device=cuda, generator=g).to(dtype)
    add = torch.randn(M, K, P, device=cuda, generator=g).to(dtype) if P else None
    v = torch.randn(M, K, W, device=cuda, generator=g).to(dtype)
    lw = torch.randn((C + P) * W, O, device=cuda, generator=g) / ((C + P) * W) ** 0.5
    lb = torch.randn(O, device=cuda, generator=g)
    edges = e if windowed else e.nei
    n = pconv_pe_conv_linear.launches
    got = pconv_pe_conv_linear(feats, edges, add, v, lw, lb)
    assert pconv_pe_conv_linear.launches == n + 1
    _check(got, pconv_pe_conv_linear_plain(feats, edges, add, v, lw, lb), dtype)


def test_launch_tile_of_the_widest_guided_layer(cuda):
    """PCFLayer at the widest level (C=80, W=16, K=16, O=160), kernel B:
    64 points per block. At M=40960, f32: one O slice (padded to 256
    columns), 640 blocks; shared memory rows 4096 + x 64*68*4 + S 64*64*4
    + two L chunks 2*64*256*4. At M=512, bf16: the 8 tiles take 5 ranges
    of 2 channel chunks and 3 O slices of 56 columns (padded to 64): 120
    blocks; rows 4096 + x 64*132*4 + S 64*136*2 + two L chunks 2*128*72*2.
    Kernel C takes B's tile over Ct = C + P channels: the flagship's
    PointConv (C=6, P=12, W=16, O=64) at M=40960 in f32, one O slice of 64,
    640 blocks; rows 4096 + x 64*68*4 + S 64*64*4 + two L chunks 2*64*64*4."""
    cores = "CUDA cores f32"
    assert launch_shape(80, 16, 16, 160, 40960, bf16=False) == dict(
        points=64, o_slices=1, o_per_slice=160, c_splits=1, blocks=640, smem=168960,
        threads=256, contraction=cores, projection=cores)
    assert launch_shape(80, 16, 16, 160, 512, bf16=True) == dict(
        points=64, o_slices=3, o_per_slice=56, c_splits=5, blocks=120, smem=92160,
        threads=256, contraction=cores, projection="mma.sync m16n8k16 bf16")
    assert launch_shape(6, 16, 16, 64, 40960, bf16=False, P=12) == dict(
        points=64, o_slices=1, o_per_slice=64, c_splits=1, blocks=640, smem=70656,
        threads=256, contraction=cores, projection=cores)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    e = _edges(cuda)
    table = torch.randn(N, 8, device=cuda)
    with pytest.raises(ValueError):
        window_resolve(table.double(), e.window_rows, e.localT)
    with pytest.raises(ValueError):
        window_scatter(torch.randn(3, 5, 8, device=cuda).double(), e.window_rows,
                       e.localT, N, torch.float32)
    with pytest.raises(ValueError):
        pcf_conv_linear(torch.randn(N, 6, device=cuda), e,
                        torch.rand(M, K, 4, device=cuda), torch.randn(M, K, 2, device=cuda),
                        torch.randn(12, 8, device=cuda), torch.randn(8, device=cuda))


FLAGSHIP_B = [(32, 64), (48, 96), (64, 128), (80, 160)]  # PCFLayer (C, O), H=8, W=16


def _band_edges(cuda, M, N, seed):
    """Windowed edges of M points over an N-row table, Morton-like bands."""
    rng = np.random.default_rng(seed)
    base = (np.arange(M) * max(N - 400, 1) // M)[:, None]
    nei = ((base + rng.integers(0, 400, size=(M, K))) % N).astype(np.int32)
    return build_windows(nei, tile=TILE, window=WIN).to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
@pytest.mark.parametrize("Mb", [512, 40960])
@pytest.mark.parametrize("C,O", FLAGSHIP_B, ids=[f"C{c}" for c, _ in FLAGSHIP_B])
def test_pcf_conv_linear_flagship_widths(cuda, C, O, Mb, windowed, dtype):
    """Kernel B at every PCFLayer width of the flagship, at the coarsest and
    the finest level's point count: the small grid splits O into slices,
    the large one takes one slice per tile."""
    e = _band_edges(cuda, Mb, max(Mb, 1024), 7)
    g = torch.Generator(device=cuda).manual_seed(3)
    n_rows = max(Mb, 1024)
    feats = torch.randn(n_rows, C, device=cuda, generator=g).to(dtype)
    guid = torch.rand(Mb, K, 8, device=cuda, generator=g).to(dtype)
    v = torch.randn(Mb, K, 16, device=cuda, generator=g).to(dtype)
    lw = torch.randn(C * 16, O, device=cuda, generator=g) / (C * 16) ** 0.5
    lb = torch.randn(O, device=cuda, generator=g)
    edges = e if windowed else e.nei
    n = pcf_conv_linear.launches
    got = pcf_conv_linear(feats, edges, guid, v, lw, lb)
    assert pcf_conv_linear.launches == n + 1
    _check(got, pcf_conv_linear_plain(feats, edges, guid, v, lw, lb), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pcf_conv_linear_partial_tile(cuda, dtype):
    """Kernel B with M not a multiple of its 64-point tile (plain edges), O
    not a multiple of 8 and heads that do not divide its channel chunk."""
    g = torch.Generator(device=cuda).manual_seed(5)
    Mp, C, H, W, O = 4000, 24, 6, 16, 44
    nei = torch.randint(0, N, (Mp, K), device=cuda, generator=g, dtype=torch.int32)
    feats = torch.randn(N, C, device=cuda, generator=g).to(dtype)
    guid = torch.rand(Mp, K, H, device=cuda, generator=g).to(dtype)
    v = torch.randn(Mp, K, W, device=cuda, generator=g).to(dtype)
    lw = torch.randn(C * W, O, device=cuda, generator=g) / (C * W) ** 0.5
    lb = torch.randn(O, device=cuda, generator=g)
    got = pcf_conv_linear(feats, nei, guid, v, lw, lb)
    _check(got, pcf_conv_linear_plain(feats, nei, guid, v, lw, lb), dtype)


def test_pcf_conv_linear_bf16_weight_follows_updates(cuda):
    """Kernel B's bf16 copy of L is rebuilt after an in-place update."""
    e = _edges(cuda, 8)
    g = torch.Generator(device=cuda).manual_seed(4)
    feats = torch.randn(N, 32, device=cuda, generator=g).bfloat16()
    guid = torch.rand(M, K, 8, device=cuda, generator=g).bfloat16()
    v = torch.randn(M, K, 16, device=cuda, generator=g).bfloat16()
    lw = torch.nn.Parameter(torch.randn(32 * 16, 64, device=cuda, generator=g) / 512 ** 0.5)
    lb = torch.randn(64, device=cuda, generator=g)
    with torch.no_grad():
        before = pcf_conv_linear(feats, e, guid, v, lw, lb)
        lw.mul_(2.0)
        after = pcf_conv_linear(feats, e, guid, v, lw, lb)
        _check(after, pcf_conv_linear_plain(feats, e, guid, v, lw, lb), torch.bfloat16)
    assert not torch.allclose(before, after)


def _check_scatter(got, want, dtype):
    """f32: the atomics' order only, within 1e-5 of the output's scale.
    bf16: one bf16 step, 2^-8 to 2^-7 of the value, as the f32 sums before
    the one cast may round to neighbouring bf16 values."""
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5 * scale,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,win", [(64, 512), (6, 512), (3, 512), (320, 1280)],
                         ids=["C64", "C6", "C3", "slab"])
def test_window_scatter_matches_plain(cuda, dtype, C, win):
    """Kernel D: the table's gradient, with window rows repeated (padding
    slots hold row 0, which real edges name too) and rows past the table
    and below it dropped. C=3 and C=6 are not multiples of 4; a window of
    1280 slots at C=320 needs several channel slabs."""
    e = _edges(cuda, 3)
    e.window_rows[0, -1] = N + 3  # dropped rows, with edges pointing at them
    e.window_rows[1, -1] = -4
    e.localT[0, 0, :5] = win - 1
    e.localT[1, 0, :5] = win - 1
    if win != WIN:  # a wider window: the same rows, more padding slots
        wr = torch.zeros(e.window_rows.shape[0], win, dtype=torch.int32, device=cuda)
        wr[:, :WIN] = e.window_rows
        wr[:, -1] = e.window_rows[:, -1]
        e.window_rows = wr.contiguous()
    g = torch.randn(e.localT.shape[0], e.localT.shape[-1], C, device=cuda).to(dtype)
    n = window_scatter.launches
    got = window_scatter(g, e.window_rows, e.localT, N, dtype)
    assert window_scatter.launches == n + 1 and got.dtype == dtype
    want = window_scatter_plain(g, e.window_rows, e.localT, N, dtype)
    _check_scatter(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 6])
def test_window_scatter_padding_fan_in(cuda, dtype, C):
    """45,000 edges name row 0 (padded points all point there, as
    core/batching.py packs them), beside ordinary neighbourhoods and a
    dropped row: the overflow pass carries the fan-in."""
    Mp, n_rows = 8192, 6000
    rng = np.random.default_rng(9)
    base = (np.arange(Mp) * (n_rows - 400) // Mp)[:, None]
    nei = (base + rng.integers(0, 400, size=(Mp, K))).astype(np.int32)
    nei.reshape(-1)[-45000:] = 0
    e = build_windows(nei, tile=TILE, window=WIN).to(cuda)
    e.window_rows[0, -1] = n_rows + 2
    e.localT[0, 0, :3] = WIN - 1
    g = torch.randn(e.localT.shape[0], e.localT.shape[-1], C, device=cuda).to(dtype)
    n = window_scatter.launches
    got = window_scatter(g, e.window_rows, e.localT, n_rows, dtype)
    assert window_scatter.launches == n + 1 and got.dtype == dtype
    _check_scatter(got, window_scatter_plain(g, e.window_rows, e.localT, n_rows, dtype),
                   dtype)


def test_window_scatter_bf16_sums_in_f32(cuda):
    """tests/test_window.py:95 on the card: every edge on row 0, bf16
    cotangents of 1 sum to exactly N*K."""
    nei = np.zeros((M, K), np.int32)
    e = build_windows(nei, tile=TILE, window=WIN).to(cuda)
    g = torch.ones(M // TILE, TILE * K, 4, device=cuda, dtype=torch.bfloat16)
    got = window_scatter(g, e.window_rows, e.localT, N, torch.bfloat16)
    assert float(got[0, 0]) == M * K and float(got[1:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_resolve_gradient_launches_the_scatter(cuda, dtype):
    e = _edges(cuda, 4)
    table = torch.randn(N, 16, device=cuda).to(dtype).requires_grad_(True)
    g = torch.randn(M // TILE, TILE * K, 16, device=cuda).to(dtype)
    n = window_scatter.launches
    (got,) = torch.autograd.grad(window_resolve(table, e.window_rows, e.localT), table, g)
    assert window_scatter.launches == n + 1
    _check_scatter(got, window_scatter_plain(g, e.window_rows, e.localT, N, dtype), dtype)


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
@pytest.mark.parametrize("guided", [True, False], ids=["B", "C"])
def test_fused_kernel_gradients_on_the_card(cuda, guided, windowed):
    """B and C under autograd on the card (kernel forward; backward through
    A and D in window mode) against the plain version's autograd, f32."""
    e = _edges(cuda, 5, out_of_range=False)
    gen = torch.Generator(device=cuda).manual_seed(2)
    C, E, W, O = 32, 8, 16, 64
    Ct = C if guided else C + E
    ins = [torch.randn(N, C, device=cuda, generator=gen),
           torch.rand(M, K, E, device=cuda, generator=gen),
           torch.randn(M, K, W, device=cuda, generator=gen),
           torch.randn(Ct * W, O, device=cuda, generator=gen) / (Ct * W) ** 0.5,
           torch.randn(O, device=cuda, generator=gen)]
    ins = [t.requires_grad_(True) for t in ins]
    edges = e if windowed else e.nei
    g = torch.randn(M, O, device=cuda, generator=gen)
    kern, plain = ((pcf_conv_linear, pcf_conv_linear_plain) if guided
                   else (pconv_pe_conv_linear, pconv_pe_conv_linear_plain))
    counts = (window_resolve.launches, window_scatter.launches)
    got = torch.autograd.grad(kern(ins[0], edges, *ins[1:]), ins, g)
    if windowed:
        assert (window_resolve.launches, window_scatter.launches) == (counts[0] + 1,
                                                                      counts[1] + 1)
    # the plain version gathers by clamped indexing, which would add the
    # gradient of out-of-range rows to rows 0 and N-1 where the kernels drop
    # it; these edges have only in-range rows
    want = torch.autograd.grad(plain(ins[0], edges, *ins[1:]), ins, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=1e-4)


# kernel C at the flagship's widths and point counts: (C, P, W, O, M) of
# PointConv, PointConvStridePE and the four PointConvTransposePE layers
FLAGSHIP_C = [(6, 12, 16, 64, 40960), (16, 16, 16, 32, 40960), (320, 32, 1, 256, 2048),
              (256, 32, 1, 192, 8192), (192, 32, 1, 128, 16384), (128, 16, 1, 64, 40960)]


def _pe_call(cuda, C, P, W, O, Mb, dtype, edges):
    g = torch.Generator(device=cuda).manual_seed(6)
    n_rows = max(Mb, 1024)
    feats = torch.randn(n_rows, C, device=cuda, generator=g).to(dtype)
    add = torch.randn(Mb, K, P, device=cuda, generator=g).to(dtype)
    v = torch.randn(Mb, K, W, device=cuda, generator=g).to(dtype)
    lw = torch.randn((C + P) * W, O, device=cuda, generator=g) / ((C + P) * W) ** 0.5
    lb = torch.randn(O, device=cuda, generator=g)
    return feats, edges, add, v, lw, lb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
@pytest.mark.parametrize("C,P,W,O,Mb", FLAGSHIP_C,
                         ids=[f"C{c}P{p}W{w}M{m}" for c, p, w, _, m in FLAGSHIP_C])
def test_pconv_pe_conv_linear_flagship_widths(cuda, C, P, W, O, Mb, windowed, dtype):
    """Kernel C at every width and point count of the flagship's PE layers,
    in both index modes and both dtypes."""
    e = _band_edges(cuda, Mb, max(Mb, 1024), 8)
    args = _pe_call(cuda, C, P, W, O, Mb, dtype, e if windowed else e.nei)
    n = pconv_pe_conv_linear.launches
    got = pconv_pe_conv_linear(*args)
    assert pconv_pe_conv_linear.launches == n + 1
    _check(got, pconv_pe_conv_linear_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pconv_pe_conv_linear_partial_tile(cuda, dtype):
    """Kernel C with M not a multiple of its 64-point tile (plain edges), O
    not a multiple of 8 and a chunk that straddles the feature and PE
    columns (C = 6)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    Mp = 4000
    nei = torch.randint(0, N, (Mp, K), device=cuda, generator=g, dtype=torch.int32)
    args = _pe_call(cuda, 6, 12, 16, 44, Mp, dtype, nei)
    args = (torch.randn(N, 6, device=cuda, generator=g).to(dtype),) + args[1:]
    _check(pconv_pe_conv_linear(*args), pconv_pe_conv_linear_plain(*args), dtype)


@pytest.mark.parametrize("C", [3, 6])
@pytest.mark.parametrize("tiles", ["many", "one"])
def test_window_resolve_flat_bit_exact(cuda, C, tiles):
    """The flat resolve of the stage geometry: [N, C] f32 -> [M, K*C]."""
    e = _edges(cuda) if tiles == "many" else _one_tile(cuda, 1)
    M_ = e.nei.shape[0]
    table = torch.randn(N, C, device=cuda)
    n, a = window_resolve_flat.launches, window_resolve.launches
    got = window_resolve_flat(table, e.window_rows, e.localT, K)
    assert (window_resolve_flat.launches, window_resolve.launches) == (n + 1, a)
    assert got.shape == (M_, K * C) and not got.requires_grad
    assert torch.equal(got, windowed_take_flat_plain(table, e.window_rows, e.localT, K))
    assert torch.equal(got.reshape(M_, K, C), table[e.nei.long().clamp(0, N - 1)])


# widths of kernel E's four layer kinds: (Cx, Cg, PE MLP dims, heads, W, O,
# shortcut width when strided); "flagship" as PCF_Normal's widest layer of
# each kind
LAYER_WIDTHS = {
    ("pcf", "small"): (8, 8, [12, 8], 2, 4, 12, 16),
    ("pcf", "flagship"): (80, 32, [12, 32], 8, 16, 160, 256),
    ("stride", "small"): (8, 0, [3, 8, 4], 0, 4, 12, 16),
    ("stride", "flagship"): (16, 0, [3, 16, 16], 0, 16, 32, 64),
    ("pointconv", "small"): (7, 0, [], 0, 4, 16, 0),
    ("pointconv", "flagship"): (6, 0, [], 0, 16, 64, 0),
    ("transpose", "small"): (32, 0, [3, 8, 4], 0, 1, 16, 0),
    ("transpose", "flagship"): (320, 0, [3, 64, 32], 0, 1, 256, 0),
}


def _layer_call(cuda, kind, width, strided, dtype, seed=0):
    """(args, kwargs) of one fused_layer_eval call on random folded weights."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    Cx, Cg, pe_dims, H, W, O, Cs = LAYER_WIDTHS[(kind, width)]
    Cs = Cs if strided else 0

    def pairs(dims):
        return [(torch.randn(ci, co, device=cuda, generator=g) / ci ** 0.5,
                 0.1 * torch.randn(co, device=cuda, generator=g))
                for ci, co in zip(dims, dims[1:])]

    wn, pe = pairs([12, 8, 8, W]), pairs(pe_dims)
    gd = pairs([Cg + pe_dims[-1], 8, H]) if kind == "pcf" else []
    Ct = Cx if gd else Cx + (12 if kind == "pointconv" else pe_dims[-1])
    nrm = torch.randn(N, 3, device=cuda, generator=g)
    geo = torch.cat([2 * torch.randn(N, 3, device=cuda, generator=g),
                     nrm / nrm.norm(dim=1, keepdim=True)], dim=1)
    cn = torch.randn(M, 3, device=cuda, generator=g)
    args = (torch.randn(N, Cx + Cg + Cs, device=cuda, generator=g).to(dtype), geo,
            _edges(cuda, seed), 2 * torch.randn(M, 3, device=cuda, generator=g),
            cn / cn.norm(dim=1, keepdim=True), wn, pe, gd,
            torch.randn(Ct * W, O, device=cuda, generator=g) / (Ct * W) ** 0.5,
            0.1 * torch.randn(O, device=cuda, generator=g))
    kw = dict(Cx=Cx, Cg=Cg, Cs=Cs, use_vi=True, pe_on_vi=kind == "pcf",
              concat_wni=kind == "pointconv", strided=strided, num_heads=H)
    return args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", ["small", "flagship"])
@pytest.mark.parametrize("kind,strided", [("pcf", False), ("pcf", True), ("stride", False),
                                          ("stride", True), ("pointconv", False),
                                          ("transpose", False)])
def test_fused_layer_eval(cuda, kind, strided, width, dtype):
    """Kernel E against its plain version: every layer kind, strided or not,
    at small and flagship widths, f32 and bf16."""
    args, kw = _layer_call(cuda, kind, width, strided, dtype)
    n = fused_layer_eval.launches
    with torch.no_grad():
        got, short = fused_layer_eval(*args, **kw)
        want, want_short = fused_layer_eval_plain(*args, **kw)
    assert fused_layer_eval.launches == n + 1 and got.dtype == dtype
    _check(got.float(), want.float(), dtype)
    if strided:
        assert torch.equal(short, want_short)
    else:
        assert short is None
    sh = layer_eval_shape(*args, **kw)
    assert sh["points"] == 64 and 0 < sh["smem"] <= 227 * 1024


def test_fused_layer_eval_refuses_what_it_does_not_take(cuda):
    args, kw = _layer_call(cuda, "pcf", "small", False, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_layer_eval(args[0].requires_grad_(True), *args[1:], **kw)
    args[0].requires_grad_(False)
    with pytest.raises(ValueError):  # the geometry must be f32
        fused_layer_eval(args[0], args[1].double(), *args[2:], **kw)
    with pytest.raises(ValueError):  # heads must divide the channels
        fused_layer_eval(*args, **dict(kw, num_heads=3))


# kernel E at every distinct layer width of the flagship fused_eval
# forward: (kind, Cx, Cg, PE MLP dims, heads, W, O, shortcut width)
FLAGSHIP_E = {
    "pointconv": ("pointconv", 6, 0, [], 0, 16, 64, 0),
    "stride": ("stride", 16, 0, [3, 16, 16], 0, 16, 32, 64),
    **{f"pcf{cx}": ("pcf", cx, 32, [12, 32], 8, 16, o, cs)
       for cx, o, cs in ((32, 64, 64), (48, 96, 128), (64, 128, 192), (80, 160, 256))},
    **{f"transpose{cx}": ("transpose", cx, 0, [3, h, p], 0, 1, o, 0)
       for cx, h, p, o in ((320, 64, 32, 256), (256, 48, 32, 192), (192, 32, 32, 128),
                           (128, 16, 16, 64))},
}


def _flagship_layer_call(cuda, spec, strided, dtype, Mb, tile=TILE, window=WIN, seed=0):
    """(args, kwargs) of one fused_layer_eval call at a flagship width over
    Mb points: the WeightNet 12-8-8-W, guidance (Cg+Cpe)-8-H, BN folded."""
    kind, Cx, Cg, pe_dims, H, W, O, Cs = spec
    Cs = Cs if strided else 0
    n_rows = max(Mb, 1024)
    g = torch.Generator(device=cuda).manual_seed(seed)

    def pairs(dims):
        return [(torch.randn(ci, co, device=cuda, generator=g) / ci ** 0.5,
                 0.1 * torch.randn(co, device=cuda, generator=g))
                for ci, co in zip(dims, dims[1:])]

    wn, pe = pairs([12, 8, 8, W]), pairs(pe_dims)
    gd = pairs([Cg + pe_dims[-1], 8, H]) if kind == "pcf" else []
    Ct = Cx if gd else Cx + (12 if kind == "pointconv" else pe_dims[-1])
    rng = np.random.default_rng(seed)
    base = (np.arange(Mb) * max(n_rows - 100, 1) // Mb)[:, None]
    nei = ((base + rng.integers(0, 100, size=(Mb, K))) % n_rows).astype(np.int32)
    nei[:, 0] = np.minimum(np.arange(Mb) * n_rows // Mb, n_rows - 1)  # a self edge first
    edges = build_windows(nei, tile=tile, window=window).to(cuda)
    nrm = torch.randn(n_rows, 3, device=cuda, generator=g)
    geo = torch.cat([2 * torch.randn(n_rows, 3, device=cuda, generator=g),
                     nrm / nrm.norm(dim=1, keepdim=True)], dim=1)
    cn = torch.randn(Mb, 3, device=cuda, generator=g)
    args = (torch.randn(n_rows, Cx + Cg + Cs, device=cuda, generator=g).to(dtype), geo, edges,
            2 * torch.randn(Mb, 3, device=cuda, generator=g),
            cn / cn.norm(dim=1, keepdim=True), wn, pe, gd,
            torch.randn(Ct * W, O, device=cuda, generator=g) / (Ct * W) ** 0.5,
            0.1 * torch.randn(O, device=cuda, generator=g))
    kw = dict(Cx=Cx, Cg=Cg, Cs=Cs, use_vi=True, pe_on_vi=kind == "pcf",
              concat_wni=kind == "pointconv", strided=strided, num_heads=H)
    return args, kw


def _check_layer(args, kw, dtype):
    n = fused_layer_eval.launches
    with torch.no_grad():
        got, short = fused_layer_eval(*args, **kw)
        want, want_short = fused_layer_eval_plain(*args, **kw)
    assert fused_layer_eval.launches == n + 1 and got.dtype == dtype
    _check(got.float(), want.float(), dtype)
    if kw["strided"]:
        assert torch.equal(short, want_short)
    else:
        assert short is None
    return got


FLAGSHIP_E_CASES = [(k, False) for k in FLAGSHIP_E] + [
    (k, True) for k in FLAGSHIP_E if k.startswith(("pcf", "stride"))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Mb", [512, 2048, 40960])
@pytest.mark.parametrize("name,strided", FLAGSHIP_E_CASES,
                         ids=[f"{k}{'-strided' if s else ''}" for k, s in FLAGSHIP_E_CASES])
def test_fused_layer_eval_flagship_widths(cuda, name, strided, Mb, dtype):
    """Kernel E at every layer width of the flagship fused_eval forward
    (PCFLayer and PointConvStridePE plain and strided, PointConv, the
    transposes), at the coarsest, a middle and the finest point count, f32
    and bf16, against its plain version; the shortcut exact."""
    args, kw = _flagship_layer_call(cuda, FLAGSHIP_E[name], strided, dtype, Mb)
    _check_layer(args, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,strided", [("pcf80", True), ("transpose320", False)])
def test_fused_layer_eval_partial_tile(cuda, name, strided, dtype):
    """Kernel E with M = 4000, not a multiple of its 64-point tile (windows
    of 8 points)."""
    args, kw = _flagship_layer_call(cuda, FLAGSHIP_E[name], strided, dtype, 4000, tile=8,
                                    window=128, seed=3)
    _check_layer(args, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_eval_pack_follows_updates(cuda, dtype):
    """Kernel E's packed weights and bf16 L are made again after an in-place
    update of a folded weight (the linear, then a guidance layer)."""
    args, kw = _flagship_layer_call(cuda, FLAGSHIP_E["pcf48"], False, dtype, 2048, seed=4)
    before = _check_layer(args, kw, dtype)
    lw, gd = args[8], args[7]
    with torch.no_grad():
        lw.mul_(2.0)
        after = _check_layer(args, kw, dtype)
        assert not torch.equal(before, after)
        gd[0][0].mul_(-1.0)
        again = _check_layer(args, kw, dtype)
    assert not torch.equal(after, again)


# ---- the captured steps (parallel/graphs.py) on the entry-size model ------
# (2 x 4000 points), against the eager bodies, at chip_smoke.py's phase-12
# tolerances: GRAPH_REL of the logits' scale for a replay (B, C and E add
# split channel ranges with f32 atomics, in another order each run), SGD
# train steps with every ReLU and max smooth within GRAPH_LOSS_RTOL and
# phase 8's gradient tolerance.

def _entry(device, seed=0, level_caps=None):
    from pcf_torch.entry import flagship_batch

    cfg, batch = flagship_batch(level0_points=4000, bucket=1024, window_gather=True,
                                device=device, seed=seed, level_caps=level_caps)
    cfg.update(USE_PALLAS_KERNEL=True, fused_min_points=0, resolve_impl="pallas")
    return cfg, batch


@pytest.mark.parametrize("path,dtype", [("standard", "float32"), ("standard", "bfloat16"),
                                        ("fused_eval", "float32"), ("fused_eval", "bfloat16"),
                                        ("flat_geom", "float32")])
def test_captured_eval_step_matches_eager(cuda, path, dtype):
    """The eval step's replay against the eager forward, and a second batch
    of other scenes packed to the same signature replaying the same graph."""
    from chip_smoke import same_as_eager
    from pcf_torch.entry import build_eval
    from pcf_torch.parallel.mesh import make_eager_eval_step

    cfg, batch = _entry(cuda)
    _, batch2 = _entry(cuda, seed=2, level_caps=[p.shape[0] for p in batch.points])
    cfg.update(compute_dtype=dtype, fused_eval=path == "fused_eval",
               flat_geom=path == "flat_geom")
    model, step = build_eval(cfg, device=cuda, seed=1)
    with torch.no_grad():
        model.train()
        model.forward_batch(batch)
    eager = make_eager_eval_step(cfg)
    want, again = eager(model, batch), eager(model, batch)
    step(model, batch)
    same_as_eager(path, step(model, batch), want, again, dtype)
    same_as_eager(path, step(model, batch2), eager(model, batch2), eager(model, batch2), dtype)
    assert step.graphs.captures == 1 and step.graphs.replays == 2


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_captured_train_steps_match_eager(cuda, rate):
    """Three captured SGD steps against three eager ones from the same
    weights, with dropout and DropPath at `rate` (the registered generator)."""
    from chip_smoke import GRAPH_LOSS_RTOL, grad_ratios, smooth_kinks
    from pcf_torch.entry import build_training
    from pcf_torch.parallel.mesh import make_eager_train_step, step_seed

    cfg, batch = _entry(cuda)
    cfg.update(optimizer="SGD", dropout_rate=rate, drop_path_rate=rate)
    (sa, captured), (sb, _) = (build_training(cfg, device=cuda),
                               build_training(cfg.copy(), device=cuda))
    eager = make_eager_train_step(cfg)
    with smooth_kinks():
        for i in range(3):
            la = captured(sa, batch, step_seed(0, i))[1]["loss"].item()
            lb = eager(sb, batch, step_seed(0, i))[1]["loss"].item()
            assert abs(la - lb) <= GRAPH_LOSS_RTOL * abs(lb), (i, la, lb)
    assert captured.graphs.captures == 1 and captured.graphs.replays == 2
    over, worst, key = grad_ratios({k: p.detach() for k, p in sa.model.named_parameters()},
                                   {k: p.detach() for k, p in sb.model.named_parameters()})
    assert over == 0, (key, worst)
    assert all(p.grad is not None for p in sa.model.parameters())


@pytest.mark.parametrize("path,dtype", [("fused_eval", "float32"), ("standard", "bfloat16")])
def test_eval_graph_follows_train_replays(cuda, path, dtype):
    """An eval step used between a captured train step's eager first call
    and two replays gives, after them, the logits of a fresh model loaded
    with the trained weights: its BN folds and bf16 copies of L were made
    again. The allocator's cache is emptied between the captures and the
    replays: nothing a live graph reads may be memory it releases."""
    from chip_smoke import same_as_eager
    from pcf_torch.entry import build, build_training
    from pcf_torch.parallel.mesh import make_eager_eval_step, make_eval_step, step_seed

    cfg, batch = _entry(cuda)
    cfg.update(compute_dtype=dtype, optimizer="SGD", fused_eval=path == "fused_eval")
    state, captured = build_training(cfg, device=cuda)
    step, eager = make_eval_step(cfg), make_eager_eval_step(cfg)
    captured(state, batch, step_seed(1, 0))
    before = step(state.model, batch)
    torch.cuda.empty_cache()
    for i in (1, 2):
        captured(state, batch, step_seed(1, i))
    fresh = build(cfg.copy(), device=cuda, seed=3)
    fresh.load_state_dict(state.model.state_dict())
    want, again = eager(fresh, batch), eager(fresh, batch)
    for _ in range(2):
        same_as_eager(path, step(state.model, batch), want, again, dtype)
    assert (before - want).abs().max() > 10 * (again - want).abs().max()


@pytest.mark.parametrize("path,dtype", [("fused_eval", "float32"), ("standard", "bfloat16")])
@pytest.mark.parametrize("writer", ["train_forward", "optimizer_update"])
def test_eval_graph_follows_in_place_writes(cuda, writer, path, dtype):
    """An eval graph captured before a train-mode forward (the BN running
    statistics, which the folds are made from) or before two
    Optimizer.update calls (torch's fused AdamW moves no _version) is
    captured again: its replay, like the eager forward, equals a fresh
    model loaded with the written weights."""
    from chip_smoke import same_as_eager
    from pcf_torch.entry import build, build_training
    from pcf_torch.parallel.mesh import make_eager_eval_step, make_eval_step

    cfg, batch = _entry(cuda)
    _, batch2 = _entry(cuda, seed=2, level_caps=[p.shape[0] for p in batch.points])
    cfg.update(compute_dtype=dtype, fused_eval=path == "fused_eval")
    state, _ = build_training(cfg, device=cuda, seed=1)
    model, step, eager = state.model, make_eval_step(cfg), make_eager_eval_step(cfg)
    with torch.no_grad():
        model.train()
        model.forward_batch(batch)
        model.eval()
    step(model, batch)
    before = step(model, batch)
    if writer == "train_forward":
        with torch.no_grad():
            model.train()
            model.forward_batch(batch2)
            model.eval()
    else:
        gen = torch.Generator(cuda).manual_seed(0)
        for _ in range(2):
            for p in model.parameters():
                p.grad = torch.randn(p.shape, generator=gen, device=cuda, dtype=p.dtype)
            state.tx.update()
    fresh = build(cfg.copy(), device=cuda, seed=3)
    fresh.load_state_dict(model.state_dict())
    want, again = eager(fresh, batch), eager(fresh, batch)
    same_as_eager(f"{path} eager after {writer}", eager(model, batch), want, again, dtype)
    step(model, batch)
    same_as_eager(f"{path} replay after {writer}", step(model, batch), want, again, dtype)
    assert step.graphs.captures == 2 and step.graphs.replays == 2
    assert (before - want).abs().max() > 10 * (again - want).abs().max()


def test_bench_prints_its_keys(cuda):
    """python3 -m pcf_torch.bench prints one JSON line with bench.py's keys
    (less the derived A100 ratio) and the card's name and power limit."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "pcf_torch.bench"], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "ms_per_batch", "ms_min", "ms_max",
                        "pts_per_sec_min", "pts_per_sec_max", "valid_points", "device"}
    assert out["valid_points"] == 40000 and out["value"] > 0
    assert out["device"] == subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


@pytest.mark.parametrize("budget", [None, 1])
def test_evaluate_graph_pools_stay_within_the_budget(cuda, tmp_path, monkeypatch, budget):
    """eval.simple.evaluate over 3 scenes of different sizes, one signature
    each, packed under no level caps, with fused_eval: a graph is captured
    per signature. Under the default budget (a quarter of the card) every
    graph stays; under a budget of 1 byte each capture drops the graphs
    before it, so the pools held are only the newest graph's, and the
    card's memory reserved after the run (the allocator's cache emptied)
    holds the newest pool and not the pools of the graphs dropped."""
    import gc

    import pcf_torch.parallel.graphs as graphs_mod
    import pcf_torch.parallel.mesh as mesh_mod
    from pcf_torch.data.synthetic import synthetic_scene
    from pcf_torch.eval.simple import evaluate
    from pcf_torch.utils.memory import graph_pool_bytes

    os.makedirs(tmp_path / "val")
    for i, n in enumerate((2000, 4000, 8000)):
        coord, norm, feats, labels = synthetic_scene(n, extent=6.0, seed=i)
        np.savez(tmp_path / "val" / f"scene{i}.npz", coords=coord,
                 feats=np.concatenate([feats, norm], 1), labels=labels, name=f"scene{i}")
    cfg, _ = _entry(cuda)
    cfg.update(fused_eval=True, window_sizes=(512, 1280, 384),
               val_data_path=str(tmp_path / "val" / "*.npz"), eval_path=str(tmp_path / "out"))
    made, captured = [], []

    def make_eval_step(*a, **kw):
        step = make(*a, **kw)
        made.append(step)
        return step

    def capture(graphs, *a, **kw):
        compiled = real_capture(graphs, *a, **kw)
        captured.append(compiled.pool_bytes)
        return compiled

    make, real_capture = mesh_mod.make_eval_step, graphs_mod.StepGraphs._capture
    monkeypatch.setattr(mesh_mod, "make_eval_step", make_eval_step)
    monkeypatch.setattr(graphs_mod.StepGraphs, "_capture", capture)
    if budget is not None:
        monkeypatch.setattr(graphs_mod, "POOL_BUDGET_BYTES", budget)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(cuda)
    evaluate(cfg, write_outputs=False, device=cuda)
    gc.collect()  # dropped graphs keep their pools until cyclic garbage goes
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_reserved(cuda) - reserved
    g = made[-1].graphs
    pools = graph_pool_bytes(g)
    print(f"evaluate over 3 signatures, budget {g.budget_bytes(cuda)}: {pools}, "
          f"captures {g.captures}, evictions {g.evictions}; pools captured {captured}, "
          f"memory reserved grew by {grown}")
    assert g.captures == 3 and g.replays == 3 and len(captured) == 3
    assert grown >= pools["pool_bytes"]
    if budget is None:
        assert g.evictions == 0 and pools["graphs"] == 3
        assert pools["pool_bytes"] <= g.budget_bytes(cuda)
    else:
        assert g.evictions == 2 and pools["graphs"] == 1
        assert pools["pool_bytes"] == list(g.entries.values())[-1].pool_bytes == captured[-1]
        # the two dropped pools went back to the card: what stays reserved
        # besides the newest pool (the model, the static batches) is less
        # than they held
        assert grown - captured[-1] < sum(captured[:-1]), (grown, captured)


# ---- the device pyramid: kNN and grid subsampling on the card ------------------

def _packed_level0(seed, scenes=4, n=3000):
    """A packed level 0 of `scenes` clustered rooms (ops on the card read
    nothing else), with padding rows."""
    from pcf_torch.core.batching import pack_scenes
    from pcf_torch.data.synthetic import synthetic_scene

    items = []
    for i in range(scenes):
        coord, norm, feats, labels = synthetic_scene(n, extent=6.0, seed=seed + i)
        items.append({"point_list": [coord.astype(np.float32)],
                      "surface_normal_list": [norm.astype(np.float32)],
                      "feature_list": feats.astype(np.float32),
                      "label_list": labels.astype(np.int32)})
    return pack_scenes(items, bucket_multiple=4096)


@pytest.mark.parametrize("k,q_tile", [(16, 512), (8, 256), (16, 64)])
def test_knn_on_the_card_matches_the_cpu(cuda, k, q_tile):
    """Self edges of a packed batch: distances within 1e-5 of the scale,
    neighbour sets equal wherever the k-th and (k+1)-th distances differ."""
    from pcf_torch.ops.knn import knn

    b = _packed_level0(0)
    args = (b.points[0], b.points[0], k + 1)
    kw = dict(query_bid=b.bids[0], ref_bid=b.bids[0], ref_mask=b.masks[0], q_tile=q_tile,
              return_dist=True)
    ci, cd = knn(*args, **kw)
    gi, gd = knn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args),
                 **{n: v.to(cuda) if isinstance(v, torch.Tensor) else v for n, v in kw.items()})
    m = b.masks[0].numpy()
    ci, cd, gi, gd = ci.numpy()[m], cd.numpy()[m], gi.cpu().numpy()[m], gd.cpu().numpy()[m]
    assert (gi[:, 0] == np.nonzero(m)[0]).all() and (gd[:, 0] == 0).all()
    np.testing.assert_allclose(gd, cd, atol=1e-5 * cd.max(), rtol=0)
    distinct = cd[:, k] - cd[:, k - 1] > 1e-6 * cd[:, k]
    same = (np.sort(gi[:, :k], 1) == np.sort(ci[:, :k], 1)).all(1)
    assert same[distinct].all()


def test_device_pyramid_on_the_card_matches_the_cpu(cuda):
    """build_pyramid_packed on the card: every level's valid rows, scenes
    and voxel count as on the CPU, barycenters within 1e-5, no overflow,
    and the edges as the kNN test holds them."""
    from scipy.spatial import cKDTree

    from pcf_torch.data.post_knn import build_pyramid_packed

    b = _packed_level0(5)
    args = ((0.1, 0.2, 0.4, 0.8, 1.6), (16384, 16384, 8192, 4096, 2048), 4, (16,) * 5,
            (16,) * 5, (16,) * 5)
    cf, co = build_pyramid_packed(b, *args)
    gf, go = build_pyramid_packed(b.to(cuda), *args)
    assert not bool(co) and not bool(go)
    for lvl in range(1, 5):
        cm, gm = cf.masks[lvl].numpy(), gf.masks[lvl].cpu().numpy()
        assert cm.sum() == gm.sum()
        for sc in range(4):
            c = cf.points[lvl].numpy()[cm & (cf.bids[lvl].numpy() == sc)]
            g = gf.points[lvl].cpu().numpy()[gm & (gf.bids[lvl].cpu().numpy() == sc)]
            assert c.shape == g.shape
            dist, near = cKDTree(g).query(c)  # each CPU barycenter's nearest on the card
            assert len(np.unique(near)) == len(near) and dist.max() <= 1e-5


def test_prepare_graph_replays_the_eager_preparation(cuda):
    """make_prepare on the card: the first call captures, the next replays
    (another batch of the same signature), each as prepare's eager result on
    the card (the barycenters' f32 atomics add in another order: points
    within 1e-5, each edge's distance within 1e-5); the overflow check
    raises on a replay too."""
    from pcf_torch.config import Config
    from pcf_torch.data.post_knn import make_prepare, prepare

    cfg = Config(grid_size=[0.1, 0.2, 0.4], K_self=16, K_forward=16, K_propagate=16,
                 BATCH_SIZE=4, device_pyramid=True, device_level_caps=[16384, 16384, 8192])
    prep = make_prepare(cfg)
    for seed in (0, 9):
        b = _packed_level0(seed)
        got, want = prep(b, cuda), prepare(b.to(cuda), cfg)
        for f in ("masks", "bids"):
            for x, y in zip(getattr(got, f), getattr(want, f)):
                assert torch.equal(x, y), f
        for x, y in zip(got.points, want.points):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        for lvl, (x, y) in enumerate(zip(got.edges_self, want.edges_self)):
            m, pts = got.masks[lvl], got.points[lvl]
            dx = ((pts[x[m].long()] - pts[m][:, None]) ** 2).sum(-1)
            dy = ((pts[y[m].long()] - pts[m][:, None]) ** 2).sum(-1)
            torch.testing.assert_close(dx, dy, atol=1e-5, rtol=0)
    assert prep.graphs.captures == 1 and prep.graphs.replays == 1
    cfg.device_level_caps = [16384, 256, 256]
    with pytest.raises(ValueError, match="overflowed"):
        prep(_packed_level0(3), cuda)
