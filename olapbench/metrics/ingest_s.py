"""Seconds inside ``Context.ingest_dataframe`` during set-up."""


def read(run):
    return run.ingest_s
