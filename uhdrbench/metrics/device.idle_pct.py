"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (the union of their intervals, on the profiler's clock)."""


def read(tr):
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
