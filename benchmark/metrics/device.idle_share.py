"""The device's idle share of the traced window, in %: 1 - the union of
kernel and copy intervals (arith.busy_union) over the window; on several
cards, the mean of the cards' idle shares (the harness sets busy_s so)."""


def read(run):
    td = run.traced
    if td is None or td.window_s <= 0 or td.busy_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
