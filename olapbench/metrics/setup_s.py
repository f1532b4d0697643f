"""Seconds from the process's start to the window's first request:
generating the data, starting the context, ingest, building or loading
the kernels and the warm-up."""


def read(run):
    return run.setup_s
