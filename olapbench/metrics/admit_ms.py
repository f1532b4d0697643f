"""Mean milliseconds of the ``wlm.admit`` phase (admission, its queue wait
included) per statement of the window."""


def read(run):
    if not run.statements:
        return None
    return sum(s["phases"].get("wlm.admit", 0.0)
               for s in run.statements) / len(run.statements)
