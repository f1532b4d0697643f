"""Datasource / segment store.

Port of ``spark_druid_olap_tpu/segment/store.py``: ``Segment``,
``Datasource`` (stacked tensors, interval and zone-map pruning) and
``SegmentStore``, without the multi-host partial-store machinery, plus
:func:`datasource_from_arrays`, which rebuilds a datasource from a plain
numpy layout so that two engines can query one identical store.

A **datasource** holds its columns time-sorted end-to-end; a **segment** is
a contiguous row-range over that order. The executable layout is the
*stacked* form: each column materialized as a ``[n_segments, padded_rows]``
array, bound to the device by the executor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.segment.column import (
    MILLIS_PER_DAY,
    ColumnKind,
    DimColumn,
    MetricColumn,
    TimeColumn,
    encode_time_millis,
)

ROW_ALIGN = 1024  # pad segment rows to a multiple of this


@dataclasses.dataclass
class Segment:
    """Metadata for one time-sharded segment (a row-range of the
    datasource)."""

    id: str
    start_row: int
    end_row: int
    min_millis: int
    max_millis: int

    @property
    def num_rows(self) -> int:
        return self.end_row - self.start_row


class Datasource:
    """A registered, ingested datasource: time-sorted columns + segment map +
    lazily-built stacked arrays."""

    def __init__(self, name: str, time: Optional[TimeColumn],
                 dims: Dict[str, DimColumn], metrics: Dict[str, MetricColumn],
                 segments: List[Segment]):
        self.name = name
        self.time = time
        self.dims = dims
        self.metrics = metrics
        self.segments = segments
        self._stacked_cache: Dict[str, np.ndarray] = {}
        self._bounds_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        n = max((s.num_rows for s in segments), default=0)
        self.padded_rows = max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)
        # the port builds complete stores only; a multi-host partial store
        # (its rows spread over processes) is ROADMAP A.8, and the
        # executor refuses select and search over one
        self.is_partial = False

    # -- basic shape ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.segments)

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def time_column(self) -> Optional[str]:
        return self.time.name if self.time is not None else None

    def interval(self) -> Tuple[int, int]:
        """(min, max+1ms) millis over all segments (≈ datasource
        intervals)."""
        if not self.segments:
            return (0, 0)
        return (min(s.min_millis for s in self.segments),
                max(s.max_millis for s in self.segments) + 1)

    def column_names(self) -> List[str]:
        out = list(self.dims) + list(self.metrics)
        if self.time is not None:
            out.append(self.time.name)
        return out

    def cardinality(self, name: str) -> Optional[int]:
        """Exact dictionary cardinality for dims, the day span for the
        time column, None for metrics."""
        if name in self.dims:
            return self.dims[name].cardinality
        if self.time is not None and name == self.time.name:
            lo, hi = self.interval()
            return max(1, (hi - lo) // MILLIS_PER_DAY + 1)
        return None

    def metadata(self) -> dict:
        """Druid segmentMetadata-equivalent summary (reference:
        ``MetadataResponse`` fields)."""
        cols = {}
        for d in self.dims.values():
            cols[d.name] = {"type": "STRING", "cardinality": d.cardinality,
                            "size": d.data_nbytes(),
                            "hasNulls": d.has_nulls()}
        for m in self.metrics.values():
            cols[m.name] = {"type": "LONG" if m.kind == ColumnKind.LONG
                            else "DOUBLE",
                            "cardinality": None, "size": m.data_nbytes(),
                            "hasNulls": m.has_nulls()}
        if self.time is not None:
            cols[self.time.name] = {"type": "TIME", "cardinality": None,
                                    "size": self.time.footprint_nbytes(),
                                    "hasNulls": False}
        return {"datasource": self.name, "numRows": self.num_rows,
                "numSegments": self.num_segments, "interval": self.interval(),
                "columns": cols}

    def column_kind(self, name: str) -> ColumnKind:
        if self.time is not None and name == self.time.name:
            return ColumnKind.TIME
        if name in self.dims:
            return ColumnKind.DIM
        if name in self.metrics:
            return self.metrics[name].kind
        raise KeyError(f"{self.name} has no column {name!r}")

    # -- stacked arrays -------------------------------------------------------
    def _stack(self, values: np.ndarray, fill=0) -> np.ndarray:
        out = np.full((self.num_segments, self.padded_rows), fill,
                      dtype=values.dtype)
        for i, s in enumerate(self.segments):
            out[i, : s.num_rows] = values[s.start_row:s.end_row]
        return out

    def stacked(self, name: str) -> np.ndarray:
        """Stacked [S, R] array for a column (codes for dims, values for
        metrics, days for time; see ``stacked_time_ms`` for the ms part)."""
        hit = self._stacked_cache.get(name)
        if hit is not None:
            return hit
        if name in self.dims:
            arr = self._stack(self.dims[name].codes)
        elif name in self.metrics:
            arr = self._stack(self.metrics[name].values)
        elif self.time is not None and name == self.time.name:
            arr = self._stack(self.time.days)
        else:
            raise KeyError(f"{self.name} has no column {name!r}")
        self._stacked_cache[name] = arr
        return arr

    def stacked_time_ms(self) -> np.ndarray:
        key = "__time_ms__"
        if key not in self._stacked_cache:
            assert self.time is not None
            self._stacked_cache[key] = self._stack(self.time.ms_in_day)
        return self._stacked_cache[key]

    def stacked_row_validity(self) -> np.ndarray:
        """[S, R] bool: True for real rows, False for padding."""
        key = "__rows__"
        if key not in self._stacked_cache:
            out = np.zeros((self.num_segments, self.padded_rows), dtype=bool)
            for i, s in enumerate(self.segments):
                out[i, : s.num_rows] = True
            self._stacked_cache[key] = out
        return self._stacked_cache[key]

    def stacked_null_validity(self, name: str) -> Optional[np.ndarray]:
        """[S, R] bool column-null validity, or None when the column has no
        nulls (padding rows read as invalid)."""
        col = self.dims.get(name) or self.metrics.get(name)
        if col is None or not col.has_nulls():
            return None
        key = f"__nulls__{name}"
        if key not in self._stacked_cache:
            self._stacked_cache[key] = self._stack(col.validity)
        return self._stacked_cache[key]

    def segment_time_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """([S] min_millis, [S] max_millis) for host-side interval pruning."""
        mins = np.array([s.min_millis for s in self.segments], dtype=np.int64)
        maxs = np.array([s.max_millis for s in self.segments], dtype=np.int64)
        return mins, maxs

    def segment_metric_bounds(self, name: str):
        """([S] min, [S] max) of a numeric metric column per segment (NaNs /
        null rows ignored) — zone-map pruning metadata."""
        hit = self._bounds_cache.get(name)
        if hit is not None:
            return hit
        col = self.metrics[name]
        vals = col.values.astype(np.float64, copy=False)
        mins = np.full(self.num_segments, np.inf)
        maxs = np.full(self.num_segments, -np.inf)
        for i, seg in enumerate(self.segments):
            s, e = seg.start_row, seg.end_row
            v = vals[s:e]
            if col.validity is not None:
                v = v[col.validity[s:e]]
            v = v[~np.isnan(v)] if v.dtype.kind == "f" else v
            if len(v):
                mins[i] = v.min()
                maxs[i] = v.max()
        self._bounds_cache[name] = (mins, maxs)
        return mins, maxs

    def prune_segments(self, intervals, filter_spec=None) -> np.ndarray:
        """Indices of segments overlapping any [lo, hi) milli-interval AND
        not provably excluded by the filter's numeric bounds (zone maps).
        Conservative: only top-level AND conjuncts prune; the full
        row-level filter still runs on the device."""
        if intervals is None:
            keep = np.ones(self.num_segments, dtype=bool)
        else:
            mins, maxs = self.segment_time_bounds()
            keep = np.zeros(self.num_segments, dtype=bool)
            for lo, hi in intervals:
                keep |= (maxs >= lo) & (mins < hi)
        if filter_spec is not None and keep.any():
            keep &= self._filter_keep_mask(filter_spec)
        return np.nonzero(keep)[0]

    def _filter_keep_mask(self, f) -> np.ndarray:
        from spark_druid_olap_tpu_torch.ir import spec as S
        ones = np.ones(self.num_segments, dtype=bool)
        if isinstance(f, S.LogicalFilter) and f.op == "and":
            keep = ones
            for x in f.fields:
                keep = keep & self._filter_keep_mask(x)
            return keep
        if isinstance(f, S.BoundFilter) and f.dimension in self.metrics \
                and self.metrics[f.dimension].kind.name in ("LONG", "DOUBLE"):
            try:
                mins, maxs = self.segment_metric_bounds(f.dimension)
                keep = ones
                if f.lower is not None:
                    lo = float(f.lower)
                    keep = keep & ((maxs > lo) if f.lower_strict
                                   else (maxs >= lo))
                if f.upper is not None:
                    hi = float(f.upper)
                    keep = keep & ((mins < hi) if f.upper_strict
                                   else (mins <= hi))
                return keep
            except (TypeError, ValueError):
                return ones
        return ones


def datasource_from_arrays(name: str, arrays: dict) -> Datasource:
    """Build a datasource from a plain-numpy layout, with no re-encoding.

    ``arrays`` holds, in time-sorted row order:

    - ``"time"``: ``None`` or ``{"name": str, "millis": int64 [n]}``, the
      time column in UTC epoch milliseconds;
    - ``"segments"``: a list of ``(start_row, end_row)`` row bounds, one per
      segment, contiguous and ascending;
    - ``"columns"``: ``{column: {"kind": "dimension" | "long" | "double" |
      "date", "values": [n] array, "validity": bool [n] or None,
      "dictionary": sorted str sequence (dimensions only)}}``. A
      dimension's ``values`` are its dictionary codes; a date column's
      are days since the epoch.

    Segment time bounds are recomputed from the time column, so a store
    carried across this way is identical, column by column, to its
    source.
    """
    tinfo = arrays.get("time")
    time_col = None
    if tinfo is not None:
        millis = np.asarray(tinfo["millis"], dtype=np.int64)
        days, ms = encode_time_millis(millis)
        time_col = TimeColumn(name=tinfo["name"], days=days, ms_in_day=ms)
    dims: Dict[str, DimColumn] = {}
    mets: Dict[str, MetricColumn] = {}
    for col, c in arrays["columns"].items():
        kind = ColumnKind(c["kind"])
        validity = c.get("validity")
        if validity is not None:
            validity = np.asarray(validity, dtype=bool)
        values = np.asarray(c["values"])
        if kind == ColumnKind.DIM:
            dims[col] = DimColumn(
                name=col, dictionary=np.asarray(list(c["dictionary"]),
                                                dtype=object),
                codes=values, validity=validity)
        else:
            mets[col] = MetricColumn(name=col, values=values,
                                     validity=validity, kind=kind)
    segments = []
    for i, (s, e) in enumerate(arrays["segments"]):
        s, e = int(s), int(e)
        if time_col is not None and e > s:
            t = time_col.millis[s:e]
            lo, hi = int(t.min()), int(t.max())
        else:
            lo = hi = 0
        segments.append(Segment(f"{name}_{i:05d}", s, e, lo, hi))
    return Datasource(name=name, time=time_col, dims=dims, metrics=mets,
                      segments=segments)


class SegmentStore:
    """Registry of ingested datasources. ``version`` is bumped on every
    register or drop; plan and result caches key on it
    (``planner/host_exec.result_cache``)."""

    def __init__(self):
        self._datasources: Dict[str, Datasource] = {}
        self.version = 0

    def register(self, ds: Datasource) -> None:
        self._datasources[ds.name] = ds
        self.version += 1

    def drop(self, name: str) -> None:
        self._datasources.pop(name, None)
        self.version += 1

    def names(self) -> List[str]:
        return sorted(self._datasources)

    def get(self, name: str) -> Datasource:
        if name not in self._datasources:
            raise KeyError(f"unknown datasource {name!r}; registered: "
                           f"{sorted(self._datasources)}")
        return self._datasources[name]
