"""device_idle_pct.<loop>: the share of the traced window in which no
kernel or copy ran on the device (torch.profiler's device intervals, their
union against the window), in percent."""


def read(t):
    if not t.traced or t.traced["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t.traced["busy_s"] / t.traced["window_s"])
