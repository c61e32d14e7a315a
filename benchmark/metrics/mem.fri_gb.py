"""The largest allocated peak while the phases oods, quotients, fri run, over the traced
requests (the phase marker reads and resets the allocator's peak at each
mark), in 10^9 bytes; on several cards, the fullest card's in each phase."""

PHASES = ("oods", "quotients", "fri",)


def read(run):
    td = run.traced
    if td is None:
        return None
    peaks = [td.phase_peaks[p] for p in PHASES if p in td.phase_peaks]
    return max(peaks) / 1e9 if peaks else None
