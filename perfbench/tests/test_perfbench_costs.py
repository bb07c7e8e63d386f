"""The frozen yardstick at small shapes: the kernels' bytes and operations,
the published peaks, and the network's FLOP count."""

from perfbench import harness
from perfbench.peaks import PEAK_BYTES, PEAK_FLOPS, least_seconds


def _conv():
    return harness.reader("conv_linear_roofline.train").__globals__["conv_cost"]


def _resolve():
    return harness.reader("window_resolve_roofline.eval").__globals__["resolve_cost"]


def test_conv_cost_plain_edges_guided():
    # B: N=10 rows of C=8 (f32), M=4 centres, K=2, H=2 guidance heads, W=3, O=5
    args = [True, ((10, 8), 4), ((4, 2), 4), None, None, ((4, 2, 2), 4), ((4, 2, 3), 4),
            ((24, 5), 4), ((5,), 4), False]
    b, ops, dt = _conv()(args)
    assert dt == "float32"
    assert b == 10 * 8 * 4 + 8 * 4 + 4 * 2 * (2 + 3) * 4 + (24 * 5 + 5) * 4 + 4 * 5 * 4
    assert ops == 2 * 4 * 2 * 8 * 3 + 2 * 4 * 8 * 3 * 5 + 4 * 2 * 8


def test_conv_cost_windowed_pe_bf16():
    # C: PE of E=4 appended, windows of 2 tiles x 6 rows, slots [2, 1, 4]
    args = [False, ((10, 8), 2), ((4, 2), 4), ((2, 6), 4), ((2, 1, 4), 4),
            ((4, 2, 4), 2), ((4, 2, 3), 2), ((36, 5), 4), ((5,), 4), True]
    b, ops, dt = _conv()(args)
    assert dt == "bfloat16"
    assert b == 10 * 8 * 2 + (12 + 8) * 4 + 4 * 2 * (4 + 3) * 2 + (36 * 5 + 5) * 4 + 4 * 5 * 4
    assert ops == 2 * 4 * 2 * 12 * 3 + 2 * 4 * 12 * 3 * 5


def test_resolve_cost():
    b, ops, dt = _resolve()([((100, 16), 2), ((3, 8), 4), ((3, 1, 32), 4)])
    assert (ops, dt) == (0, "bfloat16")
    assert b == 100 * 16 * 2 + (24 + 96) * 4 + 96 * 16 * 2


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(PEAK_BYTES, 0, "float32") == 1.0
    assert least_seconds(0, PEAK_FLOPS["bfloat16"] * 2, "bfloat16") == 2.0
    assert PEAK_FLOPS == {"float32": 67e12, "bfloat16": 989e12}


def test_flop_count_by_hand(tiny):
    """One level, no decoder: the first PointConv and its two residual
    blocks, fc1 and fc2, counted by hand at N points, K neighbours."""
    from perfbench.reference.flops import step_flops

    cell = tiny("pcf10_train_hostknn")
    cfg = dict(cell.cfg, num_level=1, feat_dim=[32], mid_dim=[16], resblocks=[0])
    N, K, mid, c = 100, 16, 16, 32

    def lin(rows, i, o):
        return 2 * rows * i * o

    wn = lin(N * K, 12, 8) + lin(N * K, 8, 8) + lin(N * K, 8, mid)
    first = wn + 2 * N * K * 18 * mid + lin(N, 18 * mid, c)
    c4 = c // 4
    block = (lin(N, c, c4) + lin(N * K, 3, c4) + lin(N * K, c4, c4) + wn
             + 2 * N * K * (2 * c4) * mid + lin(N, 2 * c4 * mid, c // 2) + lin(N, c // 2, c))
    head = lin(N, c, c) + lin(N, c, 8)
    fwd = first + 2 * block + head
    assert step_flops(cfg, [N], train=False) == fwd
    assert step_flops(cfg, [N], train=True) > 2 * fwd
