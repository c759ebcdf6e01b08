"""The share of the traced window in which no operation ran on the device, in %: 1 - busy / window,
busy the union of the device intervals."""


def read(view):
    if view.window_us <= 0:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
