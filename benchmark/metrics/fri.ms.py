"""Mean host time a traced request spends in the prove phases oods, quotients, fri
(non-synchronizing profiler ranges between prove_brainfuck's phase marks), in ms."""

PHASES = ("oods", "quotients", "fri",)


def read(run):
    td = run.traced
    if td is None or not td.requests or not any(p in td.phase_s for p in PHASES):
        return None
    return 1e3 * sum(td.phase_s.get(p, 0.0) for p in PHASES) / td.requests
