"""Datasource / segment store.

Port of ``spark_druid_olap_tpu/segment/store.py``: ``Segment``,
``Datasource`` (stacked tensors, interval and zone-map pruning, the
multi-process mesh's *partial store* with its paged ``complete()``
gather), ``restrict_to_host`` and ``SegmentStore``, plus
:func:`datasource_from_arrays`, which rebuilds a datasource (complete or
partial) from a plain numpy layout so that two engines can query one
identical store, and :func:`slice_segments`, the owned-shard slice a
cluster historical serves.

A **datasource** holds its columns time-sorted end-to-end; a **segment** is
a contiguous row-range over that order. The executable layout is the
*stacked* form: each column materialized as a ``[n_segments, padded_rows]``
array, bound to the device by the executor.
"""

from __future__ import annotations

import dataclasses
import itertools
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

# the host tier's gather of a partial store (Datasource.complete): the
# cache of gathered columns, and one exchange page when the session's
# sdot.host.gather.page.bytes does not say
GATHERED_CACHE_MAX_BYTES = 4 << 30
DEFAULT_GATHER_PAGE_BYTES = 32 << 20

# Datasource.serial: a number no other Datasource of this process takes
_SERIALS = itertools.count(1)


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
                 segments: List[Segment],
                 spatial: Optional[Dict[str, Tuple[str, ...]]] = None,
                 host_assignment=None, host_id: int = 0):
        self.name = name
        # the identity every cache of derived device state keys on (bound
        # columns, programs, lowerability): unlike id(), a datasource that
        # replaces a freed one (a re-ingest, an append) never reuses it, so
        # no entry built over the old codes or dtypes can be found again
        self.serial = next(_SERIALS)
        self.time = time
        self.dims = dims
        self.metrics = metrics
        self.segments = segments
        # spatial dim name -> numeric axis columns (the reference's
        # spatial-index column map, DruidRelationColumn spatial axes)
        self.spatial: Dict[str, Tuple[str, ...]] = {
            k: tuple(v) for k, v in (spatial or {}).items()}
        self._stacked_cache: Dict[str, np.ndarray] = {}
        self._bounds_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # multi-process partial store (parallel/multihost.py):
        # ``segments`` stays the GLOBAL metadata list (planning must be the
        # same on every process); the column arrays cover only the rows of
        # the segments assigned to ``host_id``, concatenated in ascending
        # global order. ``host_assignment`` is the global [S] -> host map
        # (≈ Druid's segment -> historical assignment,
        # DruidMetadataCache.scala:105-148).
        self.host_id = int(host_id)
        if host_assignment is None:
            self.host_assignment = None
            self.local_seg_ids = None
            self._local_pos = None
        else:
            self.host_assignment = np.asarray(host_assignment, np.int32)
            if len(self.host_assignment) != len(segments):
                raise ValueError("host_assignment length != num segments")
            self.local_seg_ids = np.nonzero(
                self.host_assignment == self.host_id)[0].astype(np.int64)
            pos = np.full(len(segments), -1, dtype=np.int64)
            pos[self.local_seg_ids] = np.arange(len(self.local_seg_ids))
            self._local_pos = pos
        # padded_rows from GLOBAL metadata: the same on every process
        n = max((s.num_rows for s in segments), default=0)
        self.padded_rows = max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)

    # -- multi-process partial stores ----------------------------------------
    @property
    def is_partial(self) -> bool:
        """True when this process holds only its host's segment rows."""
        return self.local_seg_ids is not None

    def require_complete(self, what: str = "this operation") -> None:
        """Host paths materialize full columns; on a partial store that
        would silently compute over ONE host's rows."""
        if self.is_partial:
            raise RuntimeError(
                f"{what} requires the complete datasource, but "
                f"{self.name!r} holds only host {self.host_id}'s "
                f"{len(self.local_seg_ids)}/{self.num_segments} segments "
                f"(multi-host partial store)")

    @property
    def local_num_rows(self) -> int:
        """Rows THIS process holds (``num_rows`` on a complete store)."""
        if not self.is_partial:
            return self.num_rows
        return int(sum(self.segments[int(i)].num_rows
                       for i in self.local_seg_ids))

    def local_to_global_rows(self) -> np.ndarray:
        """[local_num_rows] -> global row id (ascending: the local columns
        hold the local segments' rows in ascending global order)."""
        if not self.is_partial:
            return np.arange(self.num_rows, dtype=np.int64)
        parts = [np.arange(self.segments[int(i)].start_row,
                           self.segments[int(i)].end_row, dtype=np.int64)
                 for i in self.local_seg_ids]
        return np.concatenate(parts) if parts \
            else np.empty(0, dtype=np.int64)

    def global_to_local_rows(self, gids: np.ndarray) -> np.ndarray:
        """Global row ids (all owned by this host) -> local row offsets."""
        gids = np.asarray(gids, dtype=np.int64)
        if not self.is_partial:
            return gids
        starts = np.array([s.start_row for s in self.segments],
                          dtype=np.int64)
        seg_of = np.searchsorted(starts, gids, side="right") - 1
        local_rows = np.array(
            [self.segments[int(i)].num_rows for i in self.local_seg_ids],
            dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(local_rows)[:-1]]) \
            if len(local_rows) else np.empty(0, np.int64)
        lpos = self._local_pos[seg_of]
        if (lpos < 0).any():
            raise ValueError("global_to_local_rows: row not owned by "
                             f"host {self.host_id}")
        return base[lpos] + (gids - starts[seg_of])

    def owner_of_rows(self, gids: np.ndarray) -> np.ndarray:
        """Global row ids -> owning host id (through the segments'
        assignment)."""
        gids = np.asarray(gids, dtype=np.int64)
        starts = np.array([s.start_row for s in self.segments],
                          dtype=np.int64)
        seg_of = np.searchsorted(starts, gids, side="right") - 1
        if self.host_assignment is None:
            return np.zeros(len(gids), dtype=np.int32)
        return self.host_assignment[seg_of]

    def complete(self, columns=None, page_bytes=None) -> "Datasource":
        """A COMPLETE view of this datasource: itself when complete; on a
        partial store, a clone whose column arrays are assembled by a
        cross-process exchange (``parallel/multihost.exchange_block``), the
        safety valve that lets the host tier serve ANY statement shape
        over a partial store (≈ the reference's Spark-side fallback scan
        pulling rows off the historicals, ``DruidRelation.scala:111``).
        Engine paths never call this.

        ``columns`` prunes the gather to the needed columns (plus the time
        column, always); gathered arrays are cached per column (a
        byte-budgeted LRU of ``GATHERED_CACHE_MAX_BYTES``), so repeated
        host-tier statements exchange each column once. Gathers run in
        SORTED column order: every process must issue the same collectives
        in the same order. ``page_bytes`` (``sdot.host.gather.page.bytes``
        at the session layer) bounds ONE exchange page; page row counts
        derive from the column's per-row bytes and GLOBAL metadata, so
        every process pages the same way. The whole gather is one turn of
        ``multihost.SEQUENCER``."""
        if not self.is_partial:
            return self
        from spark_druid_olap_tpu_torch.parallel import multihost as MH
        if not MH.is_multihost():
            # a partial store in one process: nothing to gather from
            self.require_complete("cross-host gather")
        sel = sorted(k for k in list(self.dims) + list(self.metrics)
                     if columns is None or k in columns)
        key = MH.statement_key(f"complete\x00{self.name}\x00"
                               + "\x00".join(sel))
        with MH.SEQUENCER.turn(key):
            return self._complete_locked(sel, page_bytes)

    def _complete_locked(self, sel, page_bytes) -> "Datasource":
        from spark_druid_olap_tpu_torch.cache.result_cache import (
            ByteBudgetLRU)
        from spark_druid_olap_tpu_torch.parallel import multihost as MH
        cache = getattr(self, "_gathered_cols", None)
        if cache is None:
            cache = self._gathered_cols = \
                ByteBudgetLRU(GATHERED_CACHE_MAX_BYTES)
        n_rows = self.num_rows

        def plan():
            """(per-host global row ids, hosts, most local rows), from
            GLOBAL metadata only; built on the first cache miss."""
            p = getattr(self, "_gather_plan", None)
            if p is None:
                a = self.host_assignment
                n_hosts = (int(a.max()) + 1) if len(a) else 1
                gids = {}
                for h in range(n_hosts):
                    rs = [np.arange(self.segments[int(i)].start_row,
                                    self.segments[int(i)].end_row,
                                    dtype=np.int64)
                          for i in np.nonzero(a == h)[0]]
                    gids[h] = np.concatenate(rs) if rs \
                        else np.empty(0, np.int64)
                max_local = max((len(g) for g in gids.values()), default=0)
                p = self._gather_plan = (gids, n_hosts, max_local)
            return p

        budget = int(page_bytes) if page_bytes else DEFAULT_GATHER_PAGE_BYTES

        def gather(arr):
            if arr is None:
                return None
            gids, n_hosts, max_local = plan()
            # byte-budgeted paging: page rows from the column's per-row
            # bytes (schema, the same on every host), not a fixed count
            row_bytes = int(arr.dtype.itemsize) * int(
                np.prod(arr.shape[1:], dtype=np.int64))
            page = max(1, budget // max(1, row_bytes))
            n_pages = max(1, -(-max_local // page))
            out = np.empty((n_rows,) + arr.shape[1:], arr.dtype)
            offs = {h: 0 for h in range(n_hosts)}
            for c in range(n_pages):
                blocks = MH.exchange_block(arr[c * page: (c + 1) * page])
                for h, blk in enumerate(blocks):
                    if len(blk):
                        out[gids[h][offs[h]: offs[h] + len(blk)]] = blk
                        offs[h] += len(blk)
            return out

        def col(name, build):
            hit = cache.get(name)
            if hit is None:
                hit = build()
                cache.put(name, hit)
            return hit

        time = None
        if self.time is not None:
            days, ms = col("\x00time", lambda: (
                gather(self.time.days), gather(self.time.ms_in_day)))
            time = dataclasses.replace(self.time, days=days, ms_in_day=ms)
        dims, mets = {}, {}
        for k in sel:
            if k in self.dims:
                d = self.dims[k]
                codes, valid = col(k, lambda d=d: (
                    gather(d.codes), gather(d.validity)))
                dims[k] = dataclasses.replace(d, codes=codes, validity=valid)
            else:
                m = self.metrics[k]
                bounds = (m.min, m.max)
                values, valid = col(k, lambda m=m: (
                    gather(m.values), gather(m.validity)))
                mm = dataclasses.replace(m, values=values, validity=valid)
                mm._bounds_cache = bounds
                mets[k] = mm
        # dict order mirrors the source store (column_names contract)
        dims = {k: dims[k] for k in self.dims if k in dims}
        mets = {k: mets[k] for k in self.metrics if k in mets}
        ds = Datasource(name=self.name, time=time, dims=dims, metrics=mets,
                        segments=list(self.segments),
                        spatial=dict(self.spatial))
        ds.gathered_from_partial = True
        return ds

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
    def _boundaries(self):
        """Per stacked row, its (start, end) in the column arrays: one
        global row range per segment on a complete store; on a partial
        store one LOCAL range per local segment (the columns hold only
        local rows), derived from the global segment sizes."""
        if not self.is_partial:
            return [(s.start_row, s.end_row) for s in self.segments]
        sizes = np.asarray([self.segments[int(i)].num_rows
                            for i in self.local_seg_ids], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) \
            if len(sizes) else np.zeros(0, np.int64)
        return [(int(s), int(s + n)) for s, n in zip(starts, sizes)]

    def _stack(self, values: np.ndarray, fill=0) -> np.ndarray:
        bounds = self._boundaries()
        out = np.full((len(bounds), self.padded_rows), fill,
                      dtype=values.dtype)
        for i, (s, e) in enumerate(bounds):
            out[i, : e - s] = values[s:e]
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
        """[S, R] bool: True for real rows, False for padding (S = the
        local segments on a partial store)."""
        key = "__rows__"
        if key not in self._stacked_cache:
            bounds = self._boundaries()
            out = np.zeros((len(bounds), self.padded_rows), dtype=bool)
            for i, (s, e) in enumerate(bounds):
                out[i, : e - s] = True
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
        null rows ignored) — zone-map pruning metadata. A partial store
        has no per-segment bounds of other hosts' rows: it raises."""
        self.require_complete("zone-map bounds")
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
        not provably excluded by the filter's numeric or spatial bounds
        (zone maps; a spatial filter prunes by each segment's bounding box).
        Conservative: only top-level AND conjuncts prune; the full
        row-level filter still runs on the device. Zone maps read column
        data, which differs per process on a partial store, and a
        divergent pruning deadlocks the collectives: a partial store
        prunes by time (metadata) only."""
        if intervals is None:
            keep = np.ones(self.num_segments, dtype=bool)
        else:
            mins, maxs = self.segment_time_bounds()
            keep = np.zeros(self.num_segments, dtype=bool)
            for lo, hi in intervals:
                keep |= (maxs >= lo) & (mins < hi)
        if filter_spec is not None and keep.any() and not self.is_partial:
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
        if isinstance(f, S.SpatialFilter):
            keep = ones
            for ax, lo, hi in zip(f.axes, f.min_coords, f.max_coords):
                if ax not in self.metrics:
                    continue
                mins, maxs = self.segment_metric_bounds(ax)
                keep = keep & (maxs >= lo) & (mins <= hi)
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

    A multi-process partial store (``Datasource.is_partial``) also takes
    ``"host_assignment"`` (the global [S] segment -> host map),
    ``"host_id"``, ``"segment_millis"`` (the global ``(min, max)`` time
    bounds of every segment, which the local rows cannot give) and
    ``"metric_bounds"`` (``{column: (min, max)}``, the global bounds the
    cost model reads); ``segments`` stays the global row bounds, and the
    time column and ``columns`` hold the local segments' rows only, in
    ascending global order.

    Segment time bounds are recomputed from the time column where
    ``segment_millis`` is not given, so a store carried across this way
    is identical, column by column, to its source.
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
    seg_ms = arrays.get("segment_millis")
    segments = []
    for i, (s, e) in enumerate(arrays["segments"]):
        s, e = int(s), int(e)
        if seg_ms is not None:
            lo, hi = (int(v) for v in seg_ms[i])
        elif time_col is not None and e > s:
            t = time_col.millis[s:e]
            lo, hi = int(t.min()), int(t.max())
        else:
            lo = hi = 0
        segments.append(Segment(f"{name}_{i:05d}", s, e, lo, hi))
    for col, bounds in (arrays.get("metric_bounds") or {}).items():
        mets[col]._bounds_cache = tuple(bounds)
    return Datasource(name=name, time=time_col, dims=dims, metrics=mets,
                      segments=segments,
                      host_assignment=arrays.get("host_assignment"),
                      host_id=int(arrays.get("host_id", 0)))


def restrict_to_host(ds: Datasource, host_assignment,
                     host_id: int) -> Datasource:
    """Partial copy of a complete datasource holding only ``host_id``'s
    segment rows (the in-memory counterpart of the per-host streamed
    ingest: each process ingests the same frame deterministically, then
    drops the rows it does not own). Metric min / max bounds are taken
    GLOBALLY before slicing and injected, so the cost model's
    selectivity is the same on every process."""
    assignment = np.asarray(host_assignment, np.int32)
    local = np.nonzero(assignment == int(host_id))[0]
    ranges = [(ds.segments[int(i)].start_row, ds.segments[int(i)].end_row)
              for i in local]

    def _slice(arr):
        if arr is None or not ranges:
            return None if arr is None else arr[:0]
        return np.concatenate([arr[s:e] for s, e in ranges])

    dims = {k: dataclasses.replace(d, codes=_slice(d.codes),
                                   validity=_slice(d.validity))
            for k, d in ds.dims.items()}
    mets = {}
    for k, m in ds.metrics.items():
        bounds = (m.min, m.max)              # global, before the slice
        mm = dataclasses.replace(m, values=_slice(m.values),
                                 validity=_slice(m.validity))
        mm._bounds_cache = bounds
        mets[k] = mm
    time = None
    if ds.time is not None:
        time = dataclasses.replace(ds.time, days=_slice(ds.time.days),
                                   ms_in_day=_slice(ds.time.ms_in_day))
    return Datasource(name=ds.name, time=time, dims=dims, metrics=mets,
                      segments=list(ds.segments), spatial=dict(ds.spatial),
                      host_assignment=assignment, host_id=int(host_id))


def slice_segments(ds: Datasource, segment_indexes,
                   name: Optional[str] = None) -> Datasource:
    """COMPLETE datasource holding only the given segments' rows,
    renumbered to contiguous row ranges (ascending source order).

    A cluster historical registers one slice per assigned shard
    (cluster/historical.py) and every engine path — device tiers, host
    fallback, shared-scan — serves it as an ordinary datasource. Dim
    dictionaries are shared with the source; codes keep referencing the
    full dictionary, so decode stays exact on every node. Metric bounds
    are NOT inherited: a shard's local min/max is correct for its own
    rows and recomputes lazily."""
    ds.require_complete("segment slicing")
    ids = sorted(int(i) for i in segment_indexes)
    ranges = [(ds.segments[i].start_row, ds.segments[i].end_row)
              for i in ids]

    def _slice(arr):
        if arr is None:
            return None
        if not ranges:
            return arr[:0]
        return np.concatenate([arr[s:e] for s, e in ranges])

    dims = {}
    for k, d in ds.dims.items():
        dims[k] = dataclasses.replace(d, codes=_slice(d.codes),
                                      validity=_slice(d.validity))
    mets = {}
    for k, m in ds.metrics.items():
        mets[k] = dataclasses.replace(m, values=_slice(m.values),
                                      validity=_slice(m.validity))
    time = None
    if ds.time is not None:
        time = dataclasses.replace(ds.time, days=_slice(ds.time.days),
                                   ms_in_day=_slice(ds.time.ms_in_day))
    segs, row = [], 0
    for i in ids:
        s = ds.segments[i]
        n = s.end_row - s.start_row
        segs.append(Segment(s.id, row, row + n, s.min_millis, s.max_millis))
        row += n
    return Datasource(name=name or ds.name, time=time, dims=dims,
                      metrics=mets, segments=segs, spatial=dict(ds.spatial))


class SegmentStore:
    """Registry of ingested datasources. ``version`` is bumped on every
    register, drop or clear; plan caches key on it
    (``planner/host_exec.result_cache``). Each datasource also keeps its
    own ingest version, the store version at its last register or drop:
    result-cache keys fold it in, so a re-ingest invalidates only that
    datasource's cached answers (``datasource_version``). Persistence's
    recovery installs a datasource under its exact pre-crash version
    (``restore``)."""

    def __init__(self):
        self._datasources: Dict[str, Datasource] = {}
        self.version = 0
        self._versions: Dict[str, int] = {}
        # change listeners (persist/ dirty tracking), called as
        # cb(event, name) with event in register | drop | clear | restore
        self._listeners = []
        # per-datasource recovery provenance set by persist recovery
        # (source, snapshot version, checksum-verify ms); surfaced as
        # stats['persist'] on queries over a recovered datasource
        self.recovery_info: Dict[str, dict] = {}

    def add_listener(self, cb) -> None:
        self._listeners.append(cb)

    def _notify(self, event: str, name) -> None:
        for cb in self._listeners:
            try:
                cb(event, name)
            except Exception:  # noqa: BLE001 — a listener never breaks
                pass           # the store

    def register(self, ds: Datasource) -> None:
        self._datasources[ds.name] = ds
        self.version += 1
        self._versions[ds.name] = self.version
        self._notify("register", ds.name)

    def restore(self, ds: Datasource, ingest_version: int) -> None:
        """Recovery-path registration: install ``ds`` under its EXACT
        pre-crash ingest version instead of bumping. Result-cache keys
        and rollup built_version freshness compare against these
        numbers, so restoring them verbatim is what makes staleness
        semantics hold across restarts (persist/manager.py)."""
        self._datasources[ds.name] = ds
        self._versions[ds.name] = int(ingest_version)
        self.version = max(self.version, int(ingest_version))
        self._notify("restore", ds.name)

    def drop(self, name: str) -> None:
        self._datasources.pop(name, None)
        self.version += 1
        self._versions[name] = self.version
        self.recovery_info.pop(name, None)
        self._notify("drop", name)

    def clear(self) -> None:
        """Drop every datasource."""
        self._datasources.clear()
        self.version += 1
        self._versions.clear()
        self.recovery_info.clear()
        self._notify("clear", None)

    def datasource_version(self, name: str) -> int:
        """Monotone ingest version of one datasource (0 = never seen)."""
        return self._versions.get(name, 0)

    def names(self) -> List[str]:
        return sorted(self._datasources)

    def get(self, name: str) -> Datasource:
        if name not in self._datasources:
            raise KeyError(f"unknown datasource {name!r}; registered: "
                           f"{sorted(self._datasources)}")
        return self._datasources[name]
