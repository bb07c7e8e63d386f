"""window_resolve_roofline.<loop>: kernel A (window_resolve:
ops/kernels/window_resolve, csrc/window_resolve.cu) in the traced window,
as a share of its roofline: the least time of every call a
forward makes (its bytes over the memory's peak; it does no arithmetic;
call shapes recorded in the forward's eager run) times the steps traced,
over the device time of its kernels by name (resolve_wide,
resolve_narrow), in percent.

Bytes: the table and the index arrays (a window's rows and slots) read
once, the gathered rows written once.
"""

import re

from perfbench.peaks import least_seconds

_KERNEL = re.compile(r"resolve_wide|resolve_narrow")


def resolve_cost(args):
    """(bytes, operations, dtype) of one call of pcf::window_resolve or
    pcf::window_resolve_flat from its recorded arguments: table,
    window_rows, localT[, K]."""
    ((N, C), isz), (wr, _), (lt, _) = args[:3]
    slots = lt[0] * lt[-1]
    nbytes = N * C * isz + (wr[0] * wr[1] + slots) * 4 + slots * C * isz
    return nbytes, 0, "bfloat16" if isz == 2 else "float32"


def read(t):
    if not t.traced:
        return None
    calls = [a for name, a in t.calls if name in ("window_resolve", "window_resolve_flat")]
    spent = sum(s for n, s in t.traced["kernel_s"].items() if _KERNEL.search(n))
    if not calls or spent <= 0:
        return None
    least = sum(least_seconds(*resolve_cost(a)) for a in calls)
    return 100.0 * least * t.steps / spent
