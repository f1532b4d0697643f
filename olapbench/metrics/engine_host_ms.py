"""Mean milliseconds of the engine's ``bind``, ``dispatch``, ``demux`` and
``epilogue`` phases per statement of the window."""

PHASES = ("bind", "dispatch", "demux", "epilogue")


def read(run):
    if not run.statements:
        return None
    return sum(s["phases"].get(k, 0.0) for s in run.statements
               for k in PHASES) / len(run.statements)
