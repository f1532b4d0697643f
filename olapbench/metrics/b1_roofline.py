"""B1's share of its roofline, in percent: the least time of the
statements that B1 served alone (route ``kernel``), by the yardstick of
``roofline.py``, over the device seconds of B1's kernels in the trace.

Statements of a ``lanes`` group may launch B1 too; their kernels count in
the denominator and not in the numerator, so with such groups in the
window the share reads low, never high."""

from olapbench.roofline import bound_s
from olapbench.trace import kernel_seconds

KERNELS = ("dense_groupby_",)


def read(run):
    if run.trace is None:
        return None
    dev = kernel_seconds(run.trace, KERNELS)
    least = sum(bound_s(*s["work"], run.peak) for s in run.statements
                if s["route"] == "kernel")
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
