"""Mean host time a request of the window spends compiling its program and
running it on the port's VM (the benchmark's span around both), in ms."""


def read(run):
    rest = [r for r in run.requests if not r.traced]
    if not rest:
        return None
    return 1e3 * sum(r.vm_s for r in rest) / len(rest)
