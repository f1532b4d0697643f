"""Batch ingest: pandas DataFrame -> time-sharded columnar segments.

Port of ``spark_druid_olap_tpu/segment/ingest.py`` (``ingest_dataframe``,
numpy/pandas path; no native encoder, no encoding hints, no multi-host
partial ingest).

Pipeline: parse time column to UTC epoch millis -> stable-sort by time ->
build *global sorted dictionaries* per string dimension -> slice the sorted
rows into ~target_rows segments (time-contiguous, so each segment has tight
time bounds for pruning) -> encode columns.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.segment.column import (
    ColumnKind,
    DimColumn,
    MetricColumn,
    TimeColumn,
    build_dim_column,
    build_metric_column,
    encode_time_millis,
    narrow_int_dtype,
)
from spark_druid_olap_tpu_torch.segment.store import Datasource, Segment


def _to_epoch_millis(series: pd.Series) -> np.ndarray:
    if pd.api.types.is_datetime64_any_dtype(series):
        dt = series
    elif pd.api.types.is_integer_dtype(series):
        return series.to_numpy(dtype=np.int64)
    else:
        dt = pd.to_datetime(series, utc=True, format="mixed")
    vals = dt.astype("datetime64[ns, UTC]" if getattr(dt.dtype, "tz", None)
                     else "datetime64[ns]")
    return (vals.astype(np.int64) // 1_000_000).to_numpy() \
        if hasattr(vals, "to_numpy") else np.asarray(vals, np.int64) // 1_000_000


def infer_kind(series: pd.Series) -> ColumnKind:
    t = pd.api.types
    if t.is_float_dtype(series):
        return ColumnKind.DOUBLE
    if t.is_integer_dtype(series) or t.is_bool_dtype(series):
        return ColumnKind.LONG
    if t.is_datetime64_any_dtype(series):
        return ColumnKind.DATE
    return ColumnKind.DIM


def ingest_dataframe(
    name: str,
    df: pd.DataFrame,
    time_column: Optional[str] = None,
    dimensions: Optional[Iterable[str]] = None,
    metrics: Optional[Iterable[str]] = None,
    target_rows: int = 1 << 20,
    metric_kinds: Optional[Dict[str, ColumnKind]] = None,
    drop_columns: Optional[Iterable[str]] = None,
) -> Datasource:
    """Ingest a DataFrame as a datasource.

    ``dimensions``/``metrics`` override column-kind inference (a numeric
    column listed in ``dimensions`` is dictionary-encoded as a string dim).
    """
    df = df.reset_index(drop=True)
    n = len(df)

    order = None
    if time_column is not None:
        millis = _to_epoch_millis(df[time_column])
        order = np.argsort(millis, kind="stable")
        if np.array_equal(order, np.arange(n)):
            order = None        # already time-sorted
        else:
            millis = millis[order]
        days, ms_in_day = encode_time_millis(millis)
        time_col = TimeColumn(name=time_column, days=days, ms_in_day=ms_in_day)
    else:
        millis = np.zeros(n, dtype=np.int64)
        time_col = None

    dim_names = set(dimensions) if dimensions is not None else None
    metric_names = set(metrics) if metrics is not None else None
    metric_kinds = metric_kinds or {}

    def encode_one(col):
        series = df[col]
        if order is not None:
            series = series.take(order).reset_index(drop=True)
        kind = infer_kind(series)
        if dim_names is not None and col in dim_names:
            kind = ColumnKind.DIM
        elif metric_names is not None and col in metric_names:
            kind = metric_kinds.get(col) or (
                kind if kind != ColumnKind.DIM else ColumnKind.DOUBLE)
        elif col in metric_kinds:
            kind = metric_kinds[col]
        if kind == ColumnKind.DIM:
            if dim_names is not None and col in dim_names and \
                    infer_kind(series) != ColumnKind.DIM:
                raw = series.to_numpy(dtype=object)
                raw = np.array([None if v is None else str(v) for v in raw],
                               dtype=object)
                return build_dim_column(col, raw)
            return build_dim_column(col, series)
        if kind == ColumnKind.DATE:
            ms = _to_epoch_millis(series)
            days = np.floor_divide(ms, 86_400_000)
            ddt = narrow_int_dtype(int(days.min()), int(days.max())) \
                if len(days) else np.dtype(np.int32)
            return MetricColumn(name=col, values=days.astype(ddt),
                                validity=None, kind=ColumnKind.DATE)
        return build_metric_column(col, series.to_numpy(), kind)

    drop = set(drop_columns or ())
    dims, mets = {}, {}
    for col in df.columns:
        if col in drop or (time_column is not None and col == time_column):
            continue
        built = encode_one(col)
        if isinstance(built, DimColumn):
            dims[col] = built
        else:
            mets[col] = built

    segments = []
    if n > 0:
        n_seg = max(1, -(-n // target_rows))
        per = -(-n // n_seg)
        for i in range(n_seg):
            s, e = i * per, min((i + 1) * per, n)
            if s >= e:
                break
            segments.append(Segment(
                id=f"{name}_{i:05d}", start_row=s, end_row=e,
                min_millis=int(millis[s:e].min()),
                max_millis=int(millis[s:e].max())))

    return Datasource(name=name, time=time_col, dims=dims, metrics=mets,
                      segments=segments)
