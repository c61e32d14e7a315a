"""The 95th percentile of request latency over every request of the window
(host clock: from when the request is sent until its proof is on the host)."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([r.latency_s for r in run.requests], 95))
