"""Median latency of every statement sent in the window, on the client's
clock, from before its connection opens to the last byte of its answer
(refused and failed statements included)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms(), 50))
