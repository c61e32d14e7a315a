"""The device's idle share of the traced window, in %: 1 - the union of
kernel and copy intervals (arith.busy_union) over the window."""


def read(run):
    td = run.traced
    if td is None or td.window_s <= 0 or td.busy_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
