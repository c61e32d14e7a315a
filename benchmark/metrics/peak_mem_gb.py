"""torch.cuda.max_memory_allocated() over the window (reset at its start),
in 10^9 bytes; on several cards, the fullest card's."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
