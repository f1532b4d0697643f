"""Multi-host segment ownership.

Port of the one pure function of ``spark_druid_olap_tpu/parallel/
multihost.py`` that the cluster tier needs: :func:`assign_segments_to_hosts`,
the contiguous, row-balanced cut ``cluster/assign.py`` shards a datasource
with. The rest of that module (one process per host, one global mesh) is
ROADMAP A.8.
"""

from __future__ import annotations

import numpy as np


def assign_segments_to_hosts(row_counts: np.ndarray,
                             n_hosts: int) -> np.ndarray:
    """[S] -> host id. Contiguous time-blocks balanced by rows.

    Segments are time-ordered, so contiguous blocks keep a host's data one
    time range (interval pruning then prunes whole hosts, the way Druid's
    time-chunk assignment does); the row-balance objective is the
    least-load term of ``assignHistoricalServers``. Greedy split at the
    ideal cumulative boundaries — deterministic, metadata-only (every
    process computes the identical assignment)."""
    rows = np.asarray(row_counts, dtype=np.int64)
    s = len(rows)
    if n_hosts <= 1 or s == 0:
        return np.zeros(s, dtype=np.int32)
    cum = np.cumsum(rows)
    total = int(cum[-1])
    out = np.zeros(s, dtype=np.int32)
    # boundary h sits where cumulative rows pass h/n of the total
    targets = total * np.arange(1, n_hosts) / n_hosts
    cuts = np.searchsorted(cum - rows / 2.0, targets)
    prev = 0
    for h, c in enumerate(np.clip(cuts, 0, s)):
        out[prev:c] = h
        prev = max(prev, int(c))
    out[prev:] = n_hosts - 1
    return out
