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

import numpy as np
import pytest
import torch

from pcf_torch.ops.kernels.pconv_fused import (launch_shape, launch_tile,
                                               pconv_pe_conv_linear,
                                               pconv_pe_conv_linear_plain,
                                               pcf_conv_linear, pcf_conv_linear_plain)
from pcf_torch.ops.kernels.layer_eval import (fused_layer_eval, fused_layer_eval_plain,
                                              launch_tile as layer_eval_tile)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 6, 32, 96])
def test_window_resolve_bit_exact(cuda, dtype, C):
    e = _edges(cuda)
    table = torch.randn(N, C, device=cuda).to(dtype)
    n = window_resolve.launches
    got = window_resolve(table, e.window_rows, e.localT)
    assert window_resolve.launches == n + 1
    assert torch.equal(got, window_resolve_plain(table, e.window_rows, e.localT))
    assert torch.equal(got.reshape(M, K, C), table[e.nei.long().clamp(0, N - 1)])


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
    Kernel C keeps its tile (C=6, P=12: 16 points)."""
    assert launch_shape(80, 16, 16, 160, 40960, bf16=False) == dict(
        points=64, o_slices=1, o_per_slice=160, c_splits=1, blocks=640, smem=168960,
        threads=256, projection="CUDA cores f32")
    assert launch_shape(80, 16, 16, 160, 512, bf16=True) == dict(
        points=64, o_slices=3, o_per_slice=56, c_splits=5, blocks=120, smem=92160,
        threads=256, projection="mma.sync m16n8k16 bf16")
    assert launch_tile(6, 12, 16, 16) == (16, 48128)


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


@pytest.mark.parametrize("C", [3, 6])
def test_window_resolve_flat_bit_exact(cuda, C):
    """The flat resolve of the stage geometry: [N, C] f32 -> [M, K*C]."""
    e = _edges(cuda)
    table = torch.randn(N, C, device=cuda)
    n, a = window_resolve_flat.launches, window_resolve.launches
    got = window_resolve_flat(table, e.window_rows, e.localT, K)
    assert (window_resolve_flat.launches, window_resolve.launches) == (n + 1, a)
    assert got.shape == (M, K * C) and not got.requires_grad
    assert torch.equal(got, windowed_take_flat_plain(table, e.window_rows, e.localT, K))
    assert torch.equal(got.reshape(M, K, C), table[e.nei.long().clamp(0, N - 1)])


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
    mt, smem = layer_eval_tile(*args, **kw)
    assert mt in (4, 8, 16) and 0 < smem <= 227 * 1024


def test_fused_layer_eval_refuses_what_it_does_not_take(cuda):
    args, kw = _layer_call(cuda, "pcf", "small", False, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_layer_eval(args[0].requires_grad_(True), *args[1:], **kw)
    args[0].requires_grad_(False)
    with pytest.raises(ValueError):  # the geometry must be f32
        fused_layer_eval(args[0], args[1].double(), *args[2:], **kw)
    with pytest.raises(ValueError):  # heads must divide the channels
        fused_layer_eval(*args, **dict(kw, num_heads=3))
