"""95th percentile latency of every statement sent in the window,
measured as ``stmt_p50_ms`` is."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms(), 95))
