"""Mean milliseconds of the ``parse`` and ``plan.*`` phases per statement
of the window."""


def read(run):
    if not run.statements:
        return None
    return sum(v for s in run.statements for k, v in s["phases"].items()
               if k == "parse" or k.startswith("plan.")
               ) / len(run.statements)
