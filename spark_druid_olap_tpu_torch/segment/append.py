"""Streaming append: add a batch of rows to a registered datasource.

Port counterpart of ``spark_druid_olap_tpu/segment/append.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package,
less the ingest-time encoding hints (the port's ingest skips them too).
The dictionary merge takes another way to the same dictionary and codes
(:func:`_merge_dictionary`). The columns of a batch of at least
``_PARALLEL_MIN_ROWS`` rows are built on a thread pool for every caller,
where the reference builds them so only for its persist manager
(``append_dataframe(parallel=True)``); both builds give the same columns.
The write-ahead log's ``wal_kwargs_*`` serve the persist manager
(``persist/manager.py``).

The in-tree replacement for Druid's real-time (streaming) ingest tier —
the reference delegates it to Tranquility/Kafka indexing into realtime
segments that hand off to deep storage; here an append is a library call
producing a NEW :class:`Datasource` value (columns are immutable after
ingest — every cache layer depends on that), registered under the same
name so the store's ingest-version bump invalidates result caches and
marks rollups stale.

Encoding contract with batch ingest (segment/ingest.py):

- Dimension dictionaries stay *global and sorted*: new values merge into
  the dictionary and existing codes are remapped (old -> new positions
  via one searchsorted over the old dictionary). Order-preserving codes
  survive, so bound/range pushdown stays correct.
- Metric dtypes widen monotonically (narrow_int_dtype over the combined
  min/max; wide longs go int64) — appended values can never silently
  wrap.
- Appended rows are time-sorted *within the batch* and become new
  segments (≈ Druid realtime segments): the datasource is no longer
  globally time-sorted, but segment pruning only needs per-segment
  (min,max) bounds, which stay tight per batch.

Edge cases: an empty batch is a no-op (same Datasource object back, no
version bump — nothing changed, caches stay valid); an all-null column
encodes a validity mask with zeroed codes/values, same as batch ingest;
a column missing from the batch appends as all-null.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.segment.column import (
    ColumnKind,
    DimColumn,
    MetricColumn,
    TimeColumn,
    build_dim_column,
    encode_time_millis,
    narrow_int_dtype,
)
from spark_druid_olap_tpu_torch.segment.ingest import _to_epoch_millis
from spark_druid_olap_tpu_torch.segment.store import Datasource, Segment


def _null_mask(series: pd.Series) -> np.ndarray:
    return series.isna().to_numpy(dtype=bool)


def _take_remap(remap: np.ndarray, codes: np.ndarray,
                dtype: np.dtype) -> np.ndarray:
    """remap[codes] with an empty-dictionary guard (an all-null column
    has an empty dictionary but zeroed codes under its validity mask)."""
    if len(remap) == 0:
        return np.zeros(len(codes), dtype=dtype)
    return remap[codes.astype(np.int64)].astype(dtype)


def _merge_dictionary(old: np.ndarray, fresh: np.ndarray):
    """``(dictionary, remap)``: the sorted union of the sorted dictionaries
    ``old`` and ``fresh`` and each old value's position in it, or
    ``(None, None)`` when ``fresh`` adds nothing. The JAX package computes
    the same union as ``np.sort(np.concatenate([old, setdiff1d(fresh,
    old)]))`` and the positions with a ``searchsorted`` of every old value;
    here the new values are found by binary search and inserted where they
    sort, and the old positions shift by how many were inserted before
    them: O(m log n + n) for a batch of m values against n. The other
    way's ``setdiff1d`` compares every old value with the whole batch on
    an object (string) dictionary, since numpy's ``in1d`` loops for object
    dtype: O(n m) (``scripts/torch_host_paths.py`` times both)."""
    n = len(old)
    pos = np.searchsorted(old, fresh)
    new = np.ones(len(fresh), dtype=bool)
    if n:
        inside = pos < n
        new[inside] = old[pos[inside]] != fresh[inside]
    if not new.any():
        return None, None
    extra, at = fresh[new], pos[new]
    dt = np.concatenate([old[:0], extra[:0]]).dtype
    dictionary = np.insert(old.astype(dt, copy=False), at,
                           extra.astype(dt, copy=False))
    remap = np.arange(n) + np.cumsum(np.bincount(at, minlength=n + 1))[:n]
    return dictionary, remap


def _append_dim(old: DimColumn, series: Optional[pd.Series],
                n_new: int) -> DimColumn:
    if series is None:
        new_codes = np.zeros(n_new, dtype=old.codes.dtype)
        new_valid = np.zeros(n_new, dtype=bool)
        dictionary, codes = old.dictionary, old.codes
    else:
        fresh = build_dim_column(old.name, series)
        dictionary, remap = _merge_dictionary(old.dictionary,
                                              fresh.dictionary)
        if dictionary is not None:
            cdt = narrow_int_dtype(0, max(len(dictionary) - 1, 0))
            codes = _take_remap(remap, old.codes, cdt)
            new_codes = _take_remap(
                np.searchsorted(dictionary, fresh.dictionary),
                fresh.codes, cdt)
        else:
            dictionary = old.dictionary
            cdt = old.codes.dtype
            codes = old.codes
            new_codes = _take_remap(
                np.searchsorted(old.dictionary, fresh.dictionary),
                fresh.codes, cdt)
        if fresh.validity is not None:
            new_codes = np.where(fresh.validity, new_codes, 0).astype(
                new_codes.dtype)
        new_valid = fresh.validity if fresh.validity is not None \
            else np.ones(n_new, dtype=bool)
    if old.validity is None and new_valid.all():
        validity = None
    else:
        old_valid = old.validity if old.validity is not None \
            else np.ones(len(codes), dtype=bool)
        validity = np.concatenate([old_valid, new_valid])
    return DimColumn(name=old.name, dictionary=dictionary,
                     codes=np.concatenate([codes, new_codes]),
                     validity=validity)


def _append_metric(old: MetricColumn, series: Optional[pd.Series],
                   n_new: int) -> MetricColumn:
    if series is None:
        new_vals = np.zeros(n_new, dtype=old.values.dtype)
        new_valid = np.zeros(n_new, dtype=bool)
    elif old.kind == ColumnKind.DATE:
        invalid = _null_mask(series)
        ms = _to_epoch_millis(series.fillna(pd.Timestamp(0)))
        new_vals = np.floor_divide(ms, 86_400_000)
        new_vals = np.where(invalid, 0, new_vals)
        new_valid = ~invalid
    else:
        raw = series.to_numpy()
        if raw.dtype == object:
            new_valid = ~_null_mask(series)
            raw = np.where(new_valid, raw, 0)
        elif np.issubdtype(raw.dtype, np.floating):
            new_valid = ~np.isnan(raw)
            raw = np.where(new_valid, raw, 0)
        else:
            new_valid = np.ones(n_new, dtype=bool)
        new_vals = raw
    if old.kind == ColumnKind.DOUBLE:
        dtype = old.values.dtype  # float32 end-to-end
    else:
        new_valid = np.asarray(new_valid, dtype=bool)
        lows, highs = [], []
        if new_valid.any():
            nv = np.asarray(new_vals)[new_valid]
            lows.append(int(nv.min()))
            highs.append(int(nv.max()))
        olo, ohi = old.min, old.max
        if olo is not None:
            lows.append(int(olo))
            highs.append(int(ohi))
        lo = min(lows, default=0)
        hi = max(highs, default=0)
        ii = np.iinfo(np.int32)
        dtype = np.dtype(np.int64) if (lo < ii.min or hi > ii.max) \
            else narrow_int_dtype(lo, hi)
    values = np.concatenate([old.values.astype(dtype, copy=False),
                             np.asarray(new_vals).astype(dtype)])
    if old.validity is None and new_valid.all():
        validity = None
    else:
        old_valid = old.validity if old.validity is not None \
            else np.ones(len(old.values), dtype=bool)
        validity = np.concatenate([old_valid, new_valid])
    return MetricColumn(name=old.name, values=values, validity=validity,
                        kind=old.kind)


# below this many batch rows a thread pool costs more than it saves
_PARALLEL_MIN_ROWS = 2048


def _build_columns(ds: Datasource, df: pd.DataFrame, n_new: int):
    """Build the appended dim/metric columns, across a thread pool once
    the batch has ``_PARALLEL_MIN_ROWS`` rows. Each column's dictionary
    union + order-preserving remap is independent of every other column's,
    so running them concurrently is bit-identical to the serial
    comprehension — numpy's sort/searchsorted kernels release the GIL,
    which is where the parallel win comes from on wide schemas."""
    dim_items = list(ds.dims.items())
    met_items = list(ds.metrics.items())
    n_cols = len(dim_items) + len(met_items)
    if n_cols < 2 or n_new < _PARALLEL_MIN_ROWS:
        dims = {k: _append_dim(d, df[k] if k in df.columns else None,
                               n_new)
                for k, d in dim_items}
        mets = {k: _append_metric(m, df[k] if k in df.columns else None,
                                  n_new)
                for k, m in met_items}
        return dims, mets
    workers = min(n_cols, max(2, (os.cpu_count() or 4) - 1), 8)
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="sdot-append") as pool:
        dim_futs = [(k, pool.submit(
            _append_dim, d, df[k] if k in df.columns else None, n_new))
            for k, d in dim_items]
        met_futs = [(k, pool.submit(
            _append_metric, m, df[k] if k in df.columns else None, n_new))
            for k, m in met_items]
        # .result() re-raises a build rejection from any column exactly
        # like the serial path would (the pool context manager joins the
        # rest before the exception propagates)
        dims = {k: f.result() for k, f in dim_futs}
        mets = {k: f.result() for k, f in met_futs}
    return dims, mets


def append_dataframe(ds: Datasource, df: pd.DataFrame,
                     target_rows: int = 1 << 20) -> Datasource:
    """A new :class:`Datasource` with ``df``'s rows appended as fresh
    segments. ``ds`` is untouched (immutable-columns contract)."""
    ds.require_complete("stream append")
    df = df.reset_index(drop=True)
    n_new = len(df)
    if n_new == 0:
        return ds

    known = set(ds.column_names())
    extra = [c for c in df.columns if c not in known]
    if extra:
        raise ValueError(
            f"append to {ds.name!r}: columns {extra} are not in the "
            f"datasource schema (schema evolution needs a re-ingest)")

    if ds.time is not None:
        if ds.time.name not in df.columns:
            raise ValueError(
                f"append to {ds.name!r}: batch is missing the time "
                f"column {ds.time.name!r}")
        millis = _to_epoch_millis(df[ds.time.name])
        order = np.argsort(millis, kind="stable")
        if not np.array_equal(order, np.arange(n_new)):
            df = df.take(order).reset_index(drop=True)
            millis = millis[order]
        days, ms_in_day = encode_time_millis(millis)
        time_col = TimeColumn(
            name=ds.time.name,
            days=np.concatenate([ds.time.days, days]),
            ms_in_day=np.concatenate([ds.time.ms_in_day, ms_in_day]))
    else:
        millis = np.zeros(n_new, dtype=np.int64)
        time_col = None

    dims, mets = _build_columns(ds, df, n_new)

    base_row = ds.num_rows
    seg_id0 = len(ds.segments)
    segments = list(ds.segments)
    n_seg = max(1, -(-n_new // max(1, int(target_rows))))
    per = -(-n_new // n_seg)
    for i in range(n_seg):
        s, e = i * per, min((i + 1) * per, n_new)
        if s >= e:
            break
        segments.append(Segment(
            id=f"{ds.name}_{seg_id0 + i:05d}",
            start_row=base_row + s, end_row=base_row + e,
            min_millis=int(millis[s:e].min()),
            max_millis=int(millis[s:e].max())))

    return Datasource(name=ds.name, time=time_col, dims=dims,
                      metrics=mets, segments=segments,
                      spatial=dict(ds.spatial))


# JSON-serializable keys of the ingest kwargs a WAL create record carries
# (ColumnKind values serialize as their enum value strings).
_WAL_KWARG_KEYS = ("time_column", "dimensions", "metrics", "target_rows",
                   "metric_kinds", "spatial_dims", "drop_columns")


def wal_kwargs_to_dict(kwargs: dict) -> dict:
    out = {}
    for k in _WAL_KWARG_KEYS:
        v = kwargs.get(k)
        if v is None:
            continue
        if k == "metric_kinds":
            v = {c: kk.value for c, kk in v.items()}
        elif k in ("dimensions", "metrics", "drop_columns"):
            v = list(v)
        elif k == "spatial_dims":
            v = {s: list(a) for s, a in v.items()}
        out[k] = v
    return out


def wal_kwargs_from_dict(d: dict) -> dict:
    out = dict(d)
    if "metric_kinds" in out:
        out["metric_kinds"] = {c: ColumnKind(v)
                               for c, v in out["metric_kinds"].items()}
    return out


def apply_stream_ingest(ctx, name: str, df: pd.DataFrame,
                        kwargs: dict) -> Datasource:
    """In-memory half of a stream_ingest: create on first batch, append
    after. The caller (``Context.stream_ingest`` / ``PersistManager``)
    owns admission and durability."""
    from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
    existing = ctx.store._datasources.get(name)
    if existing is None:
        ds = ingest_dataframe(name, df, **kwargs)
        ctx.store.register(ds)
        return ds
    if len(df) == 0:
        return existing          # no-op: no version bump, caches stay valid
    ds = append_dataframe(existing, df,
                          target_rows=int(kwargs.get("target_rows")
                                          or (1 << 20)))
    ctx.store.register(ds)
    return ds
