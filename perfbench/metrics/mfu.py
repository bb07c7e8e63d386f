"""mfu.<loop>: the network's operations of every step in the traced window
(perfbench/reference/flops.py: the reference's matrix products at each
batch's real level sizes; forward and backward in a train loop, forward in
an eval loop) over the window, as a share of the dtype's published peak
(perfbench/peaks.py), in percent."""

from perfbench.peaks import PEAK_FLOPS


def read(t):
    if not t.traced or not t.step_flops:
        return None
    return 100.0 * sum(t.step_flops) / t.traced["window_s"] / PEAK_FLOPS[t.dtype]
