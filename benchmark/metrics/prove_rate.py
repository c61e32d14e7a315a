"""VM steps of every request completed in the window over the window's
seconds (host clock; the window ends with the last request it started)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r.steps for r in run.requests) / run.window_s
