"""prove_rate's arithmetic in a cell where the host paces the prove: VM
steps of the window's requests over the window's seconds, read in the
traced run (whose window follows the profiled requests, untraced)."""


def read(run):
    rest = [r for r in run.requests if not r.traced]
    if not rest or run.window_s <= 0:
        return None
    return sum(r.steps for r in rest) / run.window_s
