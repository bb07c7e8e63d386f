"""Each CUDA kernel against its plain PyTorch version, on the card.

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the `cuda` fixture decides, at run time).
Tolerances are chip_smoke.py's: the resolve bit-exact; the fused kernels
within 1e-4 in f32 and 1e-2 of the output scale in bf16 (a partial rounded
to bf16 after an f32 sum in another order may move one bf16 step); the
window scatter within 1e-5 of the output's scale in f32 (its atomics sum in
another order) and one bf16 step in bf16.
"""

import numpy as np
import pytest
import torch

from pcf_torch.ops.kernels.pconv_fused import (launch_tile, pconv_pe_conv_linear,
                                               pconv_pe_conv_linear_plain,
                                               pcf_conv_linear, pcf_conv_linear_plain)
from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_plain
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
    """PCFLayer at the coarsest level (C=80, H=8, W=16, K=16): 16 points
    per block, 4 * 16 * (16 * (1 + 16 + 8) + 80 * 16) bytes, above the
    48 KB that needs no opt-in."""
    assert launch_tile(True, 80, 8, 16, 16) == (16, 107520)


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
