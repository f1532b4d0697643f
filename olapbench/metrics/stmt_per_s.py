"""Statements answered in the window, per second of the window."""


def read(run):
    done = sum(1 for r in run.records
               if r["status"] == 200 and r["t_done"] <= run.deadline)
    return done / run.seconds
