"""Share of the window's statements that a fused shared-scan group served
(route ``wave`` or ``lanes``), in percent."""


def read(run):
    if not run.statements:
        return None
    fused = sum(1 for s in run.statements if s["route"] in ("wave", "lanes"))
    return 100.0 * fused / len(run.statements)
