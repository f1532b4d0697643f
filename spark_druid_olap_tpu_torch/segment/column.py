"""Column encodings for the segment store.

Port counterpart of ``spark_druid_olap_tpu/segment/column.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Druid-equivalent columnar storage (the capability the reference delegates to
the external Druid cluster; contract encoded in
``client/DruidMessages.scala:22-57`` ``MetadataResponse``/``ColumnDetails`` and
``metadata/DruidDataSource.scala:42-92``), laid out for device residency:

- **Dimensions** are dictionary-encoded with a *global, sorted* dictionary per
  datasource (Druid uses per-segment dictionaries merged at the broker; a
  global sorted dictionary makes codes comparable across segments *and*
  order-preserving, so bound/range predicates lower to integer comparisons on
  codes — no string compare ever reaches the device).
- **Metrics** are float32 / int32 device arrays (the port's aggregation
  kernels accumulate them in int64 / float64).
- **Time** is split into int32 days-since-epoch + int32 millis-in-day: the
  same layout as the JAX package, so both engines bind identical columns
  (day-grain covers OLAP time bucketing, ms-in-day restores full
  precision when required).

Null handling: validity is a separate bool mask (present only when the column
actually has nulls); codes/values under an invalid row are 0. Predicates are
three-valued at the planner: a selector/bound never matches null, ``IS NULL``
reads the validity mask — matching Druid/SQL semantics.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import pandas as pd


class ColumnKind(enum.Enum):
    DIM = "dimension"          # dictionary-encoded string
    LONG = "long"              # int32 on device
    DOUBLE = "double"          # float32 on device
    DATE = "date"              # int32 days-since-epoch (non-time date column)
    TIME = "time"              # int32 days + int32 ms-in-day


@dataclasses.dataclass
class DimColumn:
    """Dictionary-encoded string dimension.

    ``dictionary`` is sorted ascending; ``codes[i]`` indexes into it.
    ``validity`` is None when no nulls exist.
    """

    name: str
    dictionary: np.ndarray            # object array of str, sorted ascending
    codes: np.ndarray                 # int32 [n]
    validity: Optional[np.ndarray]    # bool [n] or None

    kind: ColumnKind = ColumnKind.DIM

    @property
    def cardinality(self) -> int:
        return int(len(self.dictionary))

    @property
    def code_bits(self) -> int:
        """Bits per code at this dictionary's cardinality — the
        bit-packed width an encoded snapshot stores codes at
        (encode/codecs.py bitpack; the ingest-time chooser hint).
        Metadata-only: derived from the dictionary, never the codes, so
        it is free on tiered columns."""
        return max(1, int(max(self.cardinality - 1, 0)).bit_length())

    def code_of(self, value: str) -> int:
        """Binary-search a value; -1 if absent (selector on absent value ==
        constant-false filter)."""
        i = int(np.searchsorted(self.dictionary, value))
        if i < len(self.dictionary) and self.dictionary[i] == value:
            return i
        return -1

    def code_range(self, lower=None, upper=None,
                   lower_strict: bool = False, upper_strict: bool = False):
        """Lexicographic bound -> half-open code range [lo, hi).

        This is the payoff of the sorted global dictionary: Druid's bound
        filter (``BoundFilterSpec``, reference ``DruidQuerySpec.scala:214-253``)
        becomes two integer comparisons on codes.
        """
        lo = 0
        hi = len(self.dictionary)
        if lower is not None:
            side = "right" if lower_strict else "left"
            lo = int(np.searchsorted(self.dictionary, lower, side=side))
        if upper is not None:
            side = "left" if upper_strict else "right"
            hi = int(np.searchsorted(self.dictionary, upper, side=side))
        return lo, hi

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.dictionary[np.asarray(codes, dtype=np.int64)]

    # Metadata accessors: planning / sizing paths MUST use these instead
    # of touching ``codes`` / ``validity`` directly — on a tiered column
    # (tier/handles.py) the arrays are fault-on-access properties, and a
    # dtype or nbytes peek through the array would fault the whole
    # column into the hot set.
    def data_dtype(self) -> np.dtype:
        return self.codes.dtype

    def has_nulls(self) -> bool:
        return self.validity is not None

    def data_nbytes(self) -> int:
        return int(self.codes.nbytes)

    def footprint_nbytes(self) -> int:
        v = int(self.validity.nbytes) if self.validity is not None else 0
        return int(self.codes.nbytes) + v


@dataclasses.dataclass
class MetricColumn:
    """Numeric metric column (long or double)."""

    name: str
    values: np.ndarray                # float32 / int32 [n]; int64 when wide
    validity: Optional[np.ndarray]    # bool [n] or None
    kind: ColumnKind = ColumnKind.DOUBLE

    def _bounds(self):
        """(min, max) over valid values — computed once (columns are
        immutable after ingest; the planner consults bounds on every
        query, and a full-column scan per access would dominate warm
        planning)."""
        b = getattr(self, "_bounds_cache", None)
        if b is None:
            v = self.values if self.validity is None \
                else self.values[self.validity]
            b = (v.min(), v.max()) if len(v) else (None, None)
            self._bounds_cache = b
        return b

    @property
    def min(self):
        return self._bounds()[0]

    @property
    def max(self):
        return self._bounds()[1]

    # metadata accessors (see DimColumn.data_dtype)
    def data_dtype(self) -> np.dtype:
        return self.values.dtype

    def has_nulls(self) -> bool:
        return self.validity is not None

    def data_nbytes(self) -> int:
        return int(self.values.nbytes)

    def footprint_nbytes(self) -> int:
        v = int(self.validity.nbytes) if self.validity is not None else 0
        return int(self.values.nbytes) + v


MILLIS_PER_DAY = 86_400_000


@dataclasses.dataclass
class TimeColumn:
    """The datasource time column, day/ms split (see module docstring)."""

    name: str
    days: np.ndarray                  # int32 [n], days since 1970-01-01 UTC
    ms_in_day: np.ndarray             # int32 [n]
    kind: ColumnKind = ColumnKind.TIME

    @property
    def millis(self) -> np.ndarray:
        return self.days.astype(np.int64) * MILLIS_PER_DAY + self.ms_in_day

    @property
    def min_millis(self) -> int:
        if len(self.days) == 0:
            return 0
        i = int(np.lexsort((self.ms_in_day, self.days))[0])
        return int(self.days[i]) * MILLIS_PER_DAY + int(self.ms_in_day[i])

    @property
    def max_millis(self) -> int:
        if len(self.days) == 0:
            return 0
        i = int(np.lexsort((self.ms_in_day, self.days))[-1])
        return int(self.days[i]) * MILLIS_PER_DAY + int(self.ms_in_day[i])

    # metadata accessors (see DimColumn.data_dtype)
    def data_dtype(self) -> np.dtype:
        return self.days.dtype

    def ms_dtype(self) -> np.dtype:
        return self.ms_in_day.dtype

    def has_nulls(self) -> bool:
        return False

    def data_nbytes(self) -> int:
        return int(self.days.nbytes)

    def footprint_nbytes(self) -> int:
        return int(self.days.nbytes) + int(self.ms_in_day.nbytes)


def encode_time_millis(millis: np.ndarray):
    millis = np.asarray(millis, dtype=np.int64)
    days = np.floor_divide(millis, MILLIS_PER_DAY)
    ms = millis - days * MILLIS_PER_DAY
    return days.astype(np.int32), ms.astype(np.int32)


def build_dim_column(name: str, raw: np.ndarray,
                     dictionary: Optional[np.ndarray] = None) -> DimColumn:
    """Dictionary-encode a string column.

    When ``dictionary`` is given (the datasource-global dictionary built at
    ingest), codes are looked up against it; otherwise a fresh sorted
    dictionary is built from this chunk by ``pandas.factorize(sort=True)``,
    which yields the same sorted dictionary and codes as ``np.unique`` in
    one hashing pass (the JAX package's native C++ encoder,
    ``segment/native.py``, is not ported).
    """
    raw = np.asarray(raw, dtype=object)
    # pandas-style null detection: None, float nan, or pd.NA
    validity = ~pd.isna(raw)
    has_null = not validity.all()
    safe = np.where(validity, raw, "")
    safe = safe.astype(str)
    if dictionary is None:
        codes, dictionary = pd.factorize(safe[validity] if has_null else safe,
                                         sort=True)
        if has_null:
            full = np.zeros(len(safe), dtype=np.int64)
            full[validity] = codes
            codes = full
    else:
        codes = np.searchsorted(dictionary, safe)
    cdt = narrow_int_dtype(0, max(len(dictionary) - 1, 0))
    codes = np.clip(codes, 0, max(len(dictionary) - 1, 0)).astype(cdt)
    if has_null:
        codes = np.where(validity, codes, 0).astype(cdt)
    return DimColumn(name=name, dictionary=np.asarray(dictionary, dtype=object),
                     codes=codes, validity=validity if has_null else None)


def narrow_int_dtype(lo: int, hi: int) -> np.dtype:
    """Smallest signed integer dtype holding [lo, hi]. Storage (host RSS,
    HBM residency, transfer) is bandwidth-bound; narrow columns read
    upcast to i32 inside the scan programs (ScanContext.col), so compute
    kernels never see sub-32-bit values."""
    for dt in (np.int8, np.int16, np.int32):
        ii = np.iinfo(dt)
        if lo >= ii.min and hi <= ii.max:
            return np.dtype(dt)
    return np.dtype(np.int64)


def build_metric_column(name: str, raw: np.ndarray, kind: ColumnKind) -> MetricColumn:
    raw = np.asarray(raw)
    if raw.dtype == object:
        validity = np.array([v is not None for v in raw], dtype=bool)
        raw = np.where(validity, raw, 0)
    elif np.issubdtype(raw.dtype, np.floating):
        validity = ~np.isnan(raw)
        raw = np.where(validity, raw, 0)
    else:
        validity = None
    if kind == ColumnKind.DOUBLE:
        dtype = np.float32
    else:
        # wide longs keep int64 host-side rather than silently wrapping
        # (Druid LONG is a 64-bit type); 32-bit device backends route
        # queries over them to the host tier. In-range longs store at
        # the narrowest width their min/max allows.
        i64 = raw.astype(np.int64)
        ii = np.iinfo(np.int32)
        lo, hi = (int(i64.min()), int(i64.max())) if len(i64) else (0, 0)
        wide = len(i64) > 0 and (lo < ii.min or hi > ii.max)
        dtype = np.int64 if wide else (
            narrow_int_dtype(lo, hi) if len(i64)
            else np.dtype(np.int32))
    values = raw.astype(dtype)
    has_null = validity is not None and not validity.all()
    return MetricColumn(name=name, values=values,
                        validity=validity if has_null else None, kind=kind)
