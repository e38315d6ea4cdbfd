"""The share of the traced window's host-clock time in which no operation
ran on the device (one minus the union of the device intervals), in %."""


def read(run):
    s = run.traced
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
