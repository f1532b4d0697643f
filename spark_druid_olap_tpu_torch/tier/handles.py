"""Loadable column handles: tiered columns behind the Datasource API.

Port of ``spark_druid_olap_tpu/tier/handles.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package. Two
departures: :meth:`TieredDatasource._tier_build` takes the destination
array, so the wave binder (``parallel/executor._WaveBinder``) faults each
segment's chunk straight into its pinned staging row (the JAX package
allocates a stacked ``[n, padded_rows]`` temporary per key and wave,
which the binder would copy again; the bytes that reach the device are
the same), and :meth:`TieredDatasource.wave_pins` gives the binder a pin
scope per wave (``tier/store.TieredColumnStore.wave_pins``).

A tiered datasource looks exactly like an in-memory one — same
``Datasource`` surface, same column classes — but its arrays live in the
cold tier (persist/ snapshot blobs) as per-segment :class:`BlobRef`
ranges. Two access paths share the same hot-set chunks:

- the **device bind path**: ``ops/scan.py:build_array`` and
  ``build_wave_array`` ask ``_tier_build`` first, which faults ONLY the
  segments of the wave being bound straight into the stacked
  ``[n, padded_rows]`` layout; the binder builds each wave inside
  :meth:`TieredDatasource.wave_pins`, so its chunks are pinned only while
  they are copied, and a budget-exceeding scan's residency stays within
  budget + one wave's chunks (a single-wave ``build_array`` keeps its
  chunks pinned until the statement ends);
- the **host path**: ``codes`` / ``values`` / ``days`` / … are
  properties that fault every segment's chunk and return a transient
  concatenation, so host-tier fallback, rollup builds, and metadata
  paths keep working unchanged (at full-column cost).

The classes subclass the dataclass columns with custom ``__init__``
(properties are data descriptors, so the array fields cannot be plain
attributes); ``dataclasses.replace`` therefore does NOT work on them —
tiered datasources are materialized with ``materialize()`` where an eager
copy is required (WAL-tail append).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.segment.column import (
    ColumnKind, DimColumn, MetricColumn, TimeColumn)
from spark_druid_olap_tpu_torch.segment.store import Datasource
from spark_druid_olap_tpu_torch.tier.store import BlobRef, TieredColumnStore

NULLS_PREFIX = "__nulls__"
TIME_MS_KEY = "__time_ms__"


@dataclasses.dataclass(frozen=True)
class RefArray:
    """One logical 1-D column array as per-segment blob element ranges
    (refs[i] covers segment i's rows; len(refs) == num_segments)."""

    refs: Tuple[BlobRef, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.refs)

    def materialize(self, tier: TieredColumnStore, ns: str,
                    column: str) -> np.ndarray:
        parts = [tier.fault(ns, column, r) for r in self.refs if r.count]
        if not parts:
            return np.empty(0, dtype=np.dtype(self.dtype))
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts)


class TieredDimColumn(DimColumn):
    """codes/validity fault through the hot set on access."""

    def __init__(self, name, dictionary, tier, ns,
                 codes_ra: RefArray, valid_ra: Optional[RefArray]):
        self.name = name
        self.dictionary = dictionary
        self.kind = ColumnKind.DIM
        self._tier = tier
        self._ns = ns
        self._codes_ra = codes_ra
        self._valid_ra = valid_ra

    @property
    def codes(self):
        return self._codes_ra.materialize(self._tier, self._ns, self.name)

    @property
    def validity(self):
        if self._valid_ra is None:
            return None
        return self._valid_ra.materialize(self._tier, self._ns, self.name)

    def data_dtype(self):
        return np.dtype(self._codes_ra.dtype)

    def has_nulls(self) -> bool:
        return self._valid_ra is not None

    def data_nbytes(self) -> int:
        return self._codes_ra.nbytes

    def footprint_nbytes(self) -> int:
        v = self._valid_ra.nbytes if self._valid_ra is not None else 0
        return self._codes_ra.nbytes + v

    def materialize(self) -> DimColumn:
        return DimColumn(name=self.name, dictionary=self.dictionary,
                         codes=np.array(self.codes),
                         validity=None if self._valid_ra is None
                         else np.array(self.validity))


class TieredMetricColumn(MetricColumn):
    def __init__(self, name, kind, tier, ns,
                 values_ra: RefArray, valid_ra: Optional[RefArray]):
        self.name = name
        self.kind = kind
        self._tier = tier
        self._ns = ns
        self._values_ra = values_ra
        self._valid_ra = valid_ra

    @property
    def values(self):
        return self._values_ra.materialize(self._tier, self._ns, self.name)

    @property
    def validity(self):
        if self._valid_ra is None:
            return None
        return self._valid_ra.materialize(self._tier, self._ns, self.name)

    def data_dtype(self):
        return np.dtype(self._values_ra.dtype)

    def has_nulls(self) -> bool:
        return self._valid_ra is not None

    def data_nbytes(self) -> int:
        return self._values_ra.nbytes

    def footprint_nbytes(self) -> int:
        v = self._valid_ra.nbytes if self._valid_ra is not None else 0
        return self._values_ra.nbytes + v

    def materialize(self) -> MetricColumn:
        m = MetricColumn(name=self.name, values=np.array(self.values),
                         validity=None if self._valid_ra is None
                         else np.array(self.validity), kind=self.kind)
        b = getattr(self, "_bounds_cache", None)
        if b is not None:
            m._bounds_cache = b
        return m


class TieredTimeColumn(TimeColumn):
    def __init__(self, name, tier, ns,
                 days_ra: RefArray, ms_ra: RefArray):
        self.name = name
        self.kind = ColumnKind.TIME
        self._tier = tier
        self._ns = ns
        self._days_ra = days_ra
        self._ms_ra = ms_ra

    @property
    def days(self):
        return self._days_ra.materialize(self._tier, self._ns, self.name)

    @property
    def ms_in_day(self):
        return self._ms_ra.materialize(self._tier, self._ns, self.name)

    def data_dtype(self):
        return np.dtype(self._days_ra.dtype)

    def ms_dtype(self):
        return np.dtype(self._ms_ra.dtype)

    def has_nulls(self) -> bool:
        return False

    def data_nbytes(self) -> int:
        return self._days_ra.nbytes

    def footprint_nbytes(self) -> int:
        return self._days_ra.nbytes + self._ms_ra.nbytes

    def materialize(self) -> TimeColumn:
        return TimeColumn(name=self.name, days=np.array(self.days),
                          ms_in_day=np.array(self.ms_in_day))


class TieredDatasource(Datasource):
    """A complete datasource whose column bytes live in the cold tier.

    ``_tier_refs`` maps every scan array key (ops/scan.py) to
    ``(column_name, RefArray)``; ``build_array`` consults ``_tier_build``
    before any stacked-cache path, and the wave loop's prefetch hook
    calls ``tier_prefetch``. The chunk namespace is this datasource's
    registered name, so a store drop/clear releases exactly its hot
    entries (PersistManager wires the listener)."""

    def __init__(self, *args, tier: TieredColumnStore, **kwargs):
        super().__init__(*args, **kwargs)
        self.tier = tier
        self._tier_refs: Dict[str, Tuple[str, RefArray]] = {}

    def _index_refs(self) -> None:
        """Populate the scan-key map from the (already-set) tiered
        columns. Called once by the loader after construction."""
        refs = self._tier_refs
        refs.clear()
        for k, d in self.dims.items():
            refs[k] = (k, d._codes_ra)
            if d._valid_ra is not None:
                refs[NULLS_PREFIX + k] = (k, d._valid_ra)
        for k, m in self.metrics.items():
            refs[k] = (k, m._values_ra)
            if m._valid_ra is not None:
                refs[NULLS_PREFIX + k] = (k, m._valid_ra)
        if self.time is not None:
            refs[self.time.name] = (self.time.name, self.time._days_ra)
            refs[TIME_MS_KEY] = (self.time.name, self.time._ms_ra)

    # -- scan integration -----------------------------------------------------
    def _tier_build(self, key: str, segment_indices,
                    out: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
        """The stacked block of a scan key over the requested segments,
        faulting only their chunks: into ``out`` when given (a wave's
        ``[spw, padded_rows]`` staging; rows past the segments, and each
        row past its segment's rows, are zeroed, as a dead segment's
        are), else into a fresh ``[n, padded_rows]`` array. None -> the
        caller falls back to the base path (metadata-only keys like row
        validity)."""
        ent = self._tier_refs.get(key)
        if ent is None:
            return None
        column, ra = ent
        if segment_indices is None:
            idx = list(range(self.num_segments))
        else:
            idx = [int(i) for i in segment_indices]
        if out is None:
            out = np.zeros((len(idx), self.padded_rows),
                           dtype=np.dtype(ra.dtype))
        else:
            out[len(idx):] = 0
        for row, si in enumerate(idx):
            r = ra.refs[si]
            if r.count:
                out[row, : r.count] = self.tier.fault(self.name, column, r)
            out[row, r.count:] = 0
        return out

    def wave_pins(self, devices: int = 1):
        """The hot set's pin scope for one wave's build
        (``TieredColumnStore.wave_pins``)."""
        return self.tier.wave_pins(devices)

    def tier_prefetch(self, names, segment_indices) -> None:
        """Enqueue the chunks a future wave will bind (best-effort)."""
        work: List[Tuple[str, BlobRef]] = []
        for key in names:
            ent = self._tier_refs.get(key)
            if ent is None:
                continue
            column, ra = ent
            for si in segment_indices:
                r = ra.refs[int(si)]
                if r.count:
                    work.append((column, r))
        if work:
            self.tier.prefetch(self.name, work)

    # -- planning metadata without whole-column faults ------------------------
    def segment_metric_bounds(self, name: str):
        """Zone maps computed one segment chunk at a time (the base impl
        reads the whole column, which on a tiered store would fault every
        segment at once and blow straight through the budget)."""
        hit = self._bounds_cache.get(name)
        if hit is not None:
            return hit
        ent = self._tier_refs.get(name)
        if ent is None or name not in self.metrics:
            return super().segment_metric_bounds(name)
        column, ra = ent
        vent = self._tier_refs.get(NULLS_PREFIX + name)
        if vent is None:
            # encoded columns carry per-chunk (vmin, vmax) in the codec
            # headers: zone maps come straight off the refs with ZERO
            # faults. Only valid without a null mask — headers bound
            # every stored value, including rows a validity mask voids.
            from spark_druid_olap_tpu_torch.encode import exec as EX
            hb = EX.segment_bounds_from_refs(ra.refs)
            if hb is not None:
                self._bounds_cache[name] = hb
                return hb
        mins = np.full(self.num_segments, np.inf)
        maxs = np.full(self.num_segments, -np.inf)
        for i in range(self.num_segments):
            r = ra.refs[i]
            if not r.count:
                continue
            v = self.tier.fault(self.name, column, r).astype(
                np.float64, copy=False)
            if vent is not None:
                valid = self.tier.fault(self.name, column, vent[1].refs[i])
                v = v[valid]
            v = v[~np.isnan(v)]
            if len(v):
                mins[i] = v.min()
                maxs[i] = v.max()
        self._bounds_cache[name] = (mins, maxs)
        return mins, maxs

    # -- encoded-store metadata ----------------------------------------------
    def host_bytes_per_segment(self, names=None) -> int:
        """Max over segments of the summed HOT-SET bytes the given scan
        keys fault for one segment — compressed bytes for encoded refs,
        logical bytes for raw ones. The wave planner divides its io
        budget by THIS instead of the logical segment size, so a
        compressed store admits ratio× more segments per wave under the
        same ``sdot.tier.wave.io.bytes``."""
        keys = list(self._tier_refs) if names is None else \
            [k for k in names if k in self._tier_refs]
        best = 0
        for i in range(self.num_segments):
            tot = 0
            for k in keys:
                tot += self._tier_refs[k][1].refs[i].nbytes
            best = max(best, tot)
        return best

    def encoding_info(self) -> dict:
        """Residency economics of this datasource's encoded refs (the
        source of the executor's ``last_stats["encoding"]``)."""
        enc_bytes = dec_bytes = 0
        cols = set()
        for key, (_, ra) in self._tier_refs.items():
            for r in ra.refs:
                if r.enc is not None:
                    enc_bytes += r.nbytes
                    dec_bytes += r.decoded_nbytes
                    cols.add(key)
        return {
            "encoded_keys": len(cols),
            "encoded_bytes": int(enc_bytes),
            "decoded_bytes": int(dec_bytes),
            "ratio": round(dec_bytes / enc_bytes, 3) if enc_bytes else 1.0,
        }

    # -- escape hatch ---------------------------------------------------------
    def materialize(self) -> Datasource:
        """Eager in-memory copy (plain column classes) — the escape
        hatch for paths that mutate/extend columns (WAL-tail append via
        ``dataclasses.replace``)."""
        time = self.time.materialize() if self.time is not None else None
        dims = {k: d.materialize() for k, d in self.dims.items()}
        mets = {k: m.materialize() for k, m in self.metrics.items()}
        return Datasource(name=self.name, time=time, dims=dims,
                          metrics=mets, segments=list(self.segments),
                          spatial=dict(self.spatial))
