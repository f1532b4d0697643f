"""B2's share of its roofline, in percent: the least time of the fused
launches (route ``wave``), each counted once over the union of its
statements' columns and time ranges, by the yardstick of ``roofline.py``,
over the device seconds of B2's kernels in the trace."""

from collections import defaultdict

from olapbench.roofline import bound_s, union_columns, work
from olapbench.trace import kernel_seconds

KERNELS = ("wave_partials", "wave_fold")


def read(run):
    if run.trace is None:
        return None
    dev = kernel_seconds(run.trace, KERNELS)
    groups = defaultdict(list)
    for s in run.statements:
        if s["route"] == "wave":
            groups[s["group"]].append(s)
    least = 0.0
    for members in groups.values():
        cols = union_columns(run.columns(s) for s in members)
        rows = run.time_index.rows(run.time_range(s) for s in members)
        nbytes, ops = work(run.widths, cols, rows,
                           sum(s["answer_cells"] for s in members))
        least += bound_s(nbytes, ops, run.peak)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
