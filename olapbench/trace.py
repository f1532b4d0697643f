"""Reduces a ``torch.profiler`` trace of the window to what the metrics read.

The profiler records host operations and the card's kernels, copies and
sets. From them this module keeps:

- ``device``: each device operation as ``(name, start_s, end_s)``;
- ``busy_s``: the seconds in which at least one device operation ran;
- ``window_s``: the traced window's length, on the host's clock;
- ``ops``: device seconds by operation name, largest first;
- ``gaps``: the device's idle seconds, each of the longest gaps named by
  the host operation that overlapped it most (``host_python`` where no
  recorded host operation did: the interpreter's own work).

A trace with no device record fails loudly: a profile that lost the
card's records would otherwise read as an idle card.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

LABELLED_GAPS = 2000     # the longest gaps that are named by host work
LONG_HOST_OP_S = 0.5


def _events(prof):
    """``(device, host)`` lists of ``(name, start_s, end_s)``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0, dt = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            t0, dt = e.start_us() * 1e-6, e.duration_us() * 1e-6
        item = (e.name(), t0, t0 + dt)
        if e.device_type() == DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    return device, host


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, window_s: float) -> dict:
    device, host = _events(prof)
    if not device:
        raise RuntimeError("the profiler's device timeline is empty: no "
                           "kernel, copy or set was recorded in the window")
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy)
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        ops[name] += e - s
    t_lo = min(s for _, s, _ in device + host)
    t_hi = max(e for _, _, e in device + host)
    edges = [t_lo] + [x for iv in busy for x in iv] + [t_hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = defaultdict(float)
    # host operations as starts, ends and names sorted by start; one that
    # spans more than LONG_HOST_OP_S (a wait around the whole window) would
    # name every gap, and is left out
    spans = sorted((s, e, n) for n, s, e in host if e - s <= LONG_HOST_OP_S)
    hs = np.array([x[0] for x in spans])
    he = np.array([x[1] for x in spans])
    longest = float((he - hs).max()) if spans else 0.0
    for s, e in gaps[:LABELLED_GAPS]:
        lo = int(np.searchsorted(hs, s - longest))
        hi = int(np.searchsorted(hs, e))
        best = "host_python"
        if hi > lo:
            ov = np.minimum(e, he[lo:hi]) - np.maximum(s, hs[lo:hi])
            j = int(np.argmax(ov))
            if ov[j] > 0:
                best = spans[lo + j][2]
        named[best] += e - s
    rest = sum(e - s for s, e in gaps[LABELLED_GAPS:])
    if rest > 0:
        named["(shorter gaps)"] += rest
    return {"device": device, "busy_s": busy_s, "window_s": window_s,
            "ops": sorted(ops.items(), key=lambda kv: -kv[1]),
            "gaps": sorted(named.items(), key=lambda kv: -kv[1])}


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``."""
    return sum(e - s for name, s, e in trace["device"]
               if any(n in name for n in names))
