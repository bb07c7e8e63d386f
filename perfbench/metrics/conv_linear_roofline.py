"""conv_linear_roofline.<loop>: kernels B and C (pcf_conv_linear and
pconv_pe_conv_linear: ops/kernels/pconv_fused, csrc/pcf_conv_linear.cu) in
the traced window, as a share of their roofline: the
least time of every call a step makes (bytes over the memory's peak or
operations over the dtype's peak, whichever is larger; the call shapes
recorded in the step's eager run) times the steps traced, over the device
time of the kernels by name (conv_linear_kernel and sum_ranges_kernel, the
launch that adds a call's split channel ranges), in percent.

Bytes: the table, the indices (the edges, or a window's rows and slots),
the guidance or PE rows and the WeightNet outputs, the linear's weight and
bias read once, the f32 output written once. Operations: the contraction
and the projection, and B's guidance products.
"""

import re

from perfbench.peaks import least_seconds

_KERNEL = re.compile(r"conv_linear_kernel|sum_ranges_kernel")


def conv_cost(args):
    """(bytes, operations, dtype) of one call of the pcf::conv_linear
    operator from its recorded arguments (shape, element size) in the
    operator's order: guided, feats, nei, window_rows, localT, extra,
    weights, linear_w, linear_b, keep_weight."""
    guided, feats, nei, wrows, localT, extra, weights, lw, lb = args[:9]
    (N, C), isz = feats
    M, K, W = weights[0]
    E = extra[0][-1] if extra[0] else 0
    Ct = C if guided else C + E
    (CtW, O), _ = lw
    idx = (nei[0][0] * nei[0][1] if wrows is None
           else _numel(wrows[0]) + _numel(localT[0]))
    nbytes = (N * C * isz + idx * 4 + M * K * (E + W) * isz
              + (CtW * O + lb[0][0]) * 4 + M * O * 4)
    ops = 2 * M * K * Ct * W + 2 * M * Ct * W * O + (M * K * C if guided else 0)
    return nbytes, ops, "bfloat16" if isz == 2 else "float32"


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def read(t):
    if not t.traced:
        return None
    calls = [a for name, a in t.calls if name == "conv_linear"]
    spent = sum(s for n, s in t.traced["kernel_s"].items() if _KERNEL.search(n))
    if not calls or spent <= 0:
        return None
    least = sum(least_seconds(*conv_cost(a)) for a in calls)
    return 100.0 * least * t.steps / spent
