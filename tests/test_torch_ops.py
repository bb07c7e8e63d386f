"""pcf_torch's ops against pcf_tpu's on the same numpy inputs: gathers and
the window resolve (bit-identical, against pcf_tpu's Pallas resolve in
interpret mode and its XLA resolve), the VI transform, the contractions,
and the plain versions of the three kernels (B and C against pcf_tpu's
fused Pallas kernels in interpret mode, on plain and windowed edges)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcf_tpu.ops import window as j_window
from pcf_tpu.ops.pallas import pcf_linear_fused, pconv_linear_fused
from pcf_tpu.ops.vi_transform import VI_coordinate_transform as j_vi

from pcf_torch.ops import gather as t_gather
from pcf_torch.ops import pconv as t_pconv
from pcf_torch.ops import window as t_window
from pcf_torch.ops.kernels.pconv_fused import pconv_pe_conv_linear, pcf_conv_linear
from pcf_torch.ops.kernels.window_resolve import window_resolve, window_resolve_plain
from pcf_torch.ops.vi_transform import VI_coordinate_transform as t_vi

# pcf_tpu.ops re-exports functions under these modules' names
j_gather = importlib.import_module("pcf_tpu.ops.gather")
j_pconv = importlib.import_module("pcf_tpu.ops.pconv")
# the fused kernels' tolerance in tests/test_pallas_kernels.py
FUSED_ATOL = 1e-4
# VI: the same f32 formula; sqrt/division rounding may differ in the last bits
VI_TOL = dict(atol=1e-5, rtol=1e-5)
N, M, K, TILE, WIN = 300, 64, 8, 16, 128


def _edges(seed=0, bad=(N + 5, -2, N)):
    """Windowed edges over N rows, tile 16, K 8 (128 edge slots per tile,
    so a window of 128 always holds); both packages' containers. The last
    point's first edges are the out-of-range rows `bad`."""
    nei = np.random.default_rng(seed).integers(0, N, size=(M, K)).astype(np.int32)
    nei[-1, :len(bad)] = bad  # out-of-range rows clamp, as jnp.take(mode="clip")
    return (j_window.build_windows(nei, tile=TILE, window=WIN),
            t_window.build_windows(nei, tile=TILE, window=WIN))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_take_and_index_points_bit_identical(dtype):
    je, te = _edges()
    tab = np.random.default_rng(1).standard_normal((N, 12)).astype(np.float32)
    jtab = jnp.asarray(tab).astype(dtype)
    ttab = _t(tab).to(getattr(torch, dtype))
    want = np.array(jnp.take(jtab, je.nei, axis=0, mode="clip").astype(jnp.float32))
    for impl in ("pallas", "xla"):
        got_j = j_window.windowed_take(jtab, je, interpret=True, impl=impl)
        np.testing.assert_array_equal(np.asarray(got_j.astype(jnp.float32)), want)
        np.testing.assert_array_equal(
            np.asarray(j_gather.index_points(jtab, je, impl=impl).astype(jnp.float32)),
            want)
    for got in (t_window.windowed_take(ttab, te), t_gather.index_points(ttab, te),
                t_gather.index_points(ttab, te.nei)):
        assert got.dtype == ttab.dtype
        assert torch.equal(got.float(), torch.from_numpy(want))
    # the kernel's wrapper on the CPU is its plain version
    assert torch.equal(window_resolve(ttab, te.window_rows, te.localT),
                       window_resolve_plain(ttab, te.window_rows, te.localT))


def test_index_points_batched_and_multi():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 30, 3)).astype(np.float32)
    idx = rng.integers(-3, 33, size=(2, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(j_gather.index_points(jnp.asarray(pts), jnp.asarray(idx))),
        t_gather.index_points(_t(pts), torch.from_numpy(idx)).numpy())
    a = rng.standard_normal((30, 3)).astype(np.float32)
    b = rng.standard_normal((30, 5)).astype(np.float32)
    nei = rng.integers(0, 30, size=(7, 4)).astype(np.int32)
    jt = [jnp.asarray(a), jnp.asarray(b)]
    tt = [_t(a), _t(b).bfloat16()]
    jt[1] = jt[1].astype(jnp.bfloat16)
    got = t_gather.index_points_multi(tt + [tt[0]], torch.from_numpy(nei))
    want = j_gather.index_points_multi(jt + [jt[0]], jnp.asarray(nei))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_vi_transform():
    rng = np.random.default_rng(3)
    loc = rng.standard_normal((20, 6, 3)).astype(np.float32)
    loc[0, 0] = 0.0  # the centre itself: zero offset
    gn = rng.standard_normal((20, 6, 3)).astype(np.float32)
    cn = rng.standard_normal((20, 3)).astype(np.float32)
    want = np.asarray(j_vi(jnp.asarray(loc), jnp.asarray(gn), jnp.asarray(cn)))
    got = t_vi(_t(loc), _t(gn), _t(cn)).numpy()
    assert got.shape == (20, 6, 12)
    np.testing.assert_allclose(got, want, **VI_TOL)


def test_contractions():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((N, 8)).astype(np.float32)
    nei = rng.integers(0, N, size=(M, K)).astype(np.int32)
    guid = rng.uniform(size=(M, K, 4)).astype(np.float32)
    w = rng.standard_normal((M, K, 3)).astype(np.float32)
    add = rng.standard_normal((M, K, 2)).astype(np.float32)
    lw = rng.standard_normal((10 * 3, 5)).astype(np.float32)
    lb = rng.standard_normal(5).astype(np.float32)
    g = np.asarray(j_gather.index_points(jnp.asarray(feats), jnp.asarray(nei)))
    np.testing.assert_allclose(
        t_pconv.guided_contraction(_t(g), _t(guid)).numpy(),
        np.asarray(j_pconv.guided_contraction(jnp.asarray(g), jnp.asarray(guid))),
        atol=1e-6)
    for highest in (True, False):
        prec = jax.lax.Precision.HIGHEST if highest else None
        np.testing.assert_allclose(
            t_pconv.pconv(_t(g), _t(w), highest).numpy(),
            np.asarray(j_pconv.pconv(jnp.asarray(g), jnp.asarray(w), precision=prec)),
            atol=1e-5)
    tn = torch.from_numpy(nei)
    np.testing.assert_allclose(
        t_pconv.pcf_conv(_t(feats), tn, _t(guid), _t(w)).numpy(),
        np.asarray(j_pconv.pcf_conv(*map(jnp.asarray, (feats, nei, guid, w)))), atol=1e-5)
    np.testing.assert_allclose(
        t_pconv.pconv_linear(_t(feats), tn, _t(w), _t(lw), _t(lb), _t(add)).numpy(),
        np.asarray(j_pconv.pconv_linear(*map(jnp.asarray, (feats, nei, w, lw, lb, add)))),
        atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("windowed", [False, True])
def test_fused_guided_plain_version(windowed):
    """Kernel B's plain version against pcf_linear_fused (Pallas, interpret)."""
    rng = np.random.default_rng(5)
    C, H, W, O = 16, 4, 4, 24
    je, te = _edges(6)
    feats = rng.standard_normal((N, C)).astype(np.float32)
    guid = rng.uniform(size=(M, K, H)).astype(np.float32)
    w = rng.standard_normal((M, K, W)).astype(np.float32)
    lw = (rng.standard_normal((C * W, O)) / 8).astype(np.float32)
    lb = rng.standard_normal(O).astype(np.float32)
    want = np.asarray(pcf_linear_fused(jnp.asarray(feats), je if windowed else je.nei,
                                       jnp.asarray(guid), jnp.asarray(w), jnp.asarray(lw),
                                       jnp.asarray(lb), interpret=True))
    got = pcf_conv_linear(_t(feats), te if windowed else te.nei, _t(guid), _t(w),
                          _t(lw), _t(lb))
    assert got.dtype == torch.float32 and got.shape == (M, O)
    np.testing.assert_allclose(got.numpy(), want, atol=FUSED_ATOL)


@pytest.mark.parametrize("windowed,P", [(False, 3), (True, 3), (True, 0)])
def test_fused_pe_plain_version(windowed, P):
    """Kernel C's plain version against pconv_linear_fused (Pallas,
    interpret); P = 0 is the zero-width PE of a layer without USE_PE."""
    rng = np.random.default_rng(7)
    C, W, O = 8, 4, 16
    je, te = _edges(8)
    feats = rng.standard_normal((N, C)).astype(np.float32)
    add = rng.standard_normal((M, K, P)).astype(np.float32)
    w = rng.standard_normal((M, K, W)).astype(np.float32)
    lw = (rng.standard_normal(((C + P) * W, O)) / 8).astype(np.float32)
    lb = rng.standard_normal(O).astype(np.float32)
    want = np.asarray(pconv_linear_fused(
        jnp.asarray(feats), je if windowed else je.nei, jnp.asarray(w), jnp.asarray(lw),
        jnp.asarray(lb), jnp.asarray(add) if P else None, interpret=True))
    got = pconv_pe_conv_linear(_t(feats), te if windowed else te.nei,
                               _t(add) if P else None, _t(w), _t(lw), _t(lb))
    np.testing.assert_allclose(got.numpy(), want, atol=FUSED_ATOL)


def test_fused_plain_versions_bf16_round_partials():
    """All-bf16 operands: the plain versions round the [M, C*W] partials and
    L to bf16 before the f32 projection, as pcf_tpu's kernels do. Held
    against pcf_linear_fused in interpret mode at 2e-2, the step of a bf16
    partial (2^-8 relative) times the output's scale here."""
    rng = np.random.default_rng(9)
    C, H, W, O = 16, 4, 4, 8
    je, te = _edges(10)
    feats = rng.standard_normal((N, C)).astype(np.float32)
    guid = rng.uniform(size=(M, K, H)).astype(np.float32)
    w = rng.standard_normal((M, K, W)).astype(np.float32)
    lw = (rng.standard_normal((C * W, O)) / 8).astype(np.float32)
    lb = rng.standard_normal(O).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(pcf_linear_fused(
        jnp.asarray(feats).astype(bf), je, jnp.asarray(guid).astype(bf),
        jnp.asarray(w).astype(bf), jnp.asarray(lw), jnp.asarray(lb), interpret=True))
    b16 = torch.bfloat16
    got = pcf_conv_linear(_t(feats).to(b16), te, _t(guid).to(b16), _t(w).to(b16),
                          _t(lw), _t(lb))
    f32 = pcf_conv_linear(_t(feats).to(b16).float(), te, _t(guid).to(b16).float(),
                          _t(w).to(b16).float(), _t(lw), _t(lb))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)
    assert not torch.equal(got, f32)  # the bf16 rounding is really applied


# ---- gradients: the resolve's backward (kernel D's plain version) and the
# fused kernels' autograd, against jax.vjp of pcf_tpu's custom VJPs with the
# Pallas resolve in interpret mode

@pytest.fixture
def pallas_resolve(monkeypatch):
    """pcf_tpu's fused VJPs read the resolve implementation at trace time."""
    monkeypatch.setattr(j_window, "_RESOLVE_IMPL", "pallas")


def test_windowed_take_gradient_drops_out_of_range_rows():
    """f32 at tests/test_window.py's 3e-5. Rows N+5, -2 and N are clamped in
    the forward but their gradient is dropped, as pcf_tpu's scatter-add
    (mode="drop") drops N+5 and N; clamped indexing would add it to rows 0
    and N-1. pcf_tpu wraps the negative row -2 to N-2 in that scatter (jnp
    index normalisation) although its forward reads row 0 for it; the port
    drops it (ROADMAP.md Queue 3), so row N-2 is compared without it."""
    je, te = _edges(11)
    rng = np.random.default_rng(12)
    tab = rng.standard_normal((N, 12)).astype(np.float32)
    g = rng.standard_normal((M, K, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_window.windowed_take(t, je, interpret=True,
                                                      impl="pallas"), jnp.asarray(tab))
    want = np.array(vjp(jnp.asarray(g))[0])
    want[N - 2] -= g[M - 1, 1]  # the edge with row -2
    ttab = _t(tab).requires_grad_(True)
    (got,) = torch.autograd.grad(t_window.windowed_take(ttab, te), ttab, _t(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-6)
    clamped = torch.autograd.grad(ttab[te.nei.long().clamp(0, N - 1)], ttab, _t(g))[0]
    assert not torch.allclose(clamped[[0, N - 1]], got[[0, N - 1]])


def test_windowed_take_gradient_bf16_sums_in_f32():
    """tests/test_window.py:95: every edge on row 0, bf16 cotangents of 1;
    the f32 sum then one cast gives N*K exactly."""
    n_pts, k = 256, 16
    te = t_window.build_windows(np.zeros((n_pts, k), np.int32), tile=128, window=128)
    tab = torch.zeros(n_pts, 4, dtype=torch.bfloat16, requires_grad=True)
    t_window.windowed_take(tab, te).float().sum().backward()
    assert tab.grad.dtype == torch.bfloat16
    assert float(tab.grad[0, 0]) == n_pts * k
    assert float(tab.grad[1:].abs().max()) == 0.0


def _fused_inputs(seed, C, E, W, O, guided):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, C)).astype(np.float32)
    extra = (rng.uniform(size=(M, K, E)) if guided
             else rng.standard_normal((M, K, E))).astype(np.float32)
    w = rng.standard_normal((M, K, W)).astype(np.float32)
    Ct = C if guided else C + E
    lw = (rng.standard_normal((Ct * W, O)) / 8).astype(np.float32)
    lb = rng.standard_normal(O).astype(np.float32)
    g = rng.standard_normal((M, O)).astype(np.float32)
    return feats, extra, w, lw, lb, g


@pytest.mark.parametrize("guided", [True, False], ids=["B", "C"])
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nei"])
def test_fused_kernel_gradients(pallas_resolve, guided, windowed):
    """Kernels B and C through their autograd Function against jax.vjp of
    _pcf_linear_win / _pconv_pe_linear_win / _pcf_linear / _pconv_pe_linear,
    every input's gradient, at the fused kernels' atol 1e-4; the edges hold
    rows past the table (dropped in window mode, clamped in nei mode, on
    both sides)."""
    from pcf_tpu.ops.pallas import pconv_kernel as jk

    C, E, W, O = 16, 4 if guided else 3, 4, 12
    je, te = _edges(13, bad=(N + 5, N))
    inputs = _fused_inputs(14, C, E, W, O, guided)
    feats, extra, w, lw, lb, g = map(jnp.asarray, inputs)
    if windowed:
        fn = jk._pcf_linear_win if guided else jk._pconv_pe_linear_win
        _, vjp = jax.vjp(lambda *a: fn((M, K), True, a[0], je.window_rows, je.localT,
                                       *a[1:]), feats, extra, w, lw, lb)
    else:
        fn = jk._pcf_linear if guided else jk._pconv_pe_linear
        _, vjp = jax.vjp(lambda *a: fn(a[0], je.nei, *a[1:], True), feats, extra, w, lw, lb)
    want = vjp(g)
    ts = [_t(x).requires_grad_(True) for x in inputs[:5]]
    kern = pcf_conv_linear if guided else pconv_pe_conv_linear
    out = kern(ts[0], te if windowed else te.nei, *ts[1:])
    got = torch.autograd.grad(out, ts, _t(inputs[5]))
    for name, a, b in zip(("feats", "extra", "weights", "linear_w", "linear_b"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_kernel_gradients_random_sizes(pallas_resolve, seed):
    """Random widths, window mode, guided and PE: 1e-3 with rtol 1e-4, the
    op tolerance for random sizes."""
    from pcf_tpu.ops.pallas import pconv_kernel as jk

    r = np.random.default_rng(100 + seed)
    H = int(r.choice([2, 4]))
    C, P, W, O = H * int(r.integers(1, 6)), int(r.integers(1, 9)), int(r.integers(1, 9)), \
        int(r.integers(4, 40))
    je, te = _edges(20 + seed, bad=(N + 5, N))
    for guided, E in ((True, H), (False, P)):
        inputs = _fused_inputs(30 + seed, C, E, W, O, guided)
        feats, extra, w, lw, lb, g = map(jnp.asarray, inputs)
        fn = jk._pcf_linear_win if guided else jk._pconv_pe_linear_win
        _, vjp = jax.vjp(lambda *a: fn((M, K), True, a[0], je.window_rows, je.localT,
                                       *a[1:]), feats, extra, w, lw, lb)
        ts = [_t(x).requires_grad_(True) for x in inputs[:5]]
        out = (pcf_conv_linear if guided else pconv_pe_conv_linear)(ts[0], te, *ts[1:])
        got = torch.autograd.grad(out, ts, _t(inputs[5]))
        for a, b in zip(got, vjp(g)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3, rtol=1e-4)
