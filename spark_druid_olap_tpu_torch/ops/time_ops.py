"""Calendar / time-bucketing kernels — pure int32 tensor arithmetic.

Port of ``spark_druid_olap_tpu/ops/time_ops.py``. Host helpers (literal
lowering, calendar conversion for decode) are copied unchanged; the
vectorized functions take torch tensors (a numpy array is wrapped as a
CPU tensor, which plan-time cardinality probes rely on).

Everything operates on **int32 days since 1970-01-01 UTC** (plus int32
millis-in-day when sub-day precision is needed). The civil-calendar
conversion uses Howard Hinnant's ``civil_from_days`` algorithm in
vectorized integer ops, so year/month/day extraction needs no lookup
tables.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

MILLIS_PER_DAY = 86_400_000


def _t(x):
    """numpy -> CPU tensor; tensors pass through."""
    return torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def interval_day_range(lo_ms: int, hi_ms: int):
    """Split a [lo_ms, hi_ms) interval into the (day, millis-in-day)
    split the engine stores time in: (day_lo, rem_lo, day_hi, rem_hi)."""
    day_lo, rem_lo = divmod(int(lo_ms), MILLIS_PER_DAY)
    day_hi, rem_hi = divmod(int(hi_ms), MILLIS_PER_DAY)
    return day_lo, rem_lo, day_hi, rem_hi


def civil_from_days(days):
    """days-since-epoch -> (year, month, day), vectorized int32.

    Hinnant's algorithm (http://howardhinnant.github.io/date_algorithms.html);
    all intermediates fit int32 for any realistic OLAP time range.
    """
    z = _t(days) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)                   # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))   # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side inverse (for lowering date literals)."""
    return (_dt.date(y, m, d) - _dt.date(1970, 1, 1)).days


def date_literal_to_days(value) -> int:
    """Lower a date literal ('1995-03-15', date, datetime, numpy datetime64)
    to days-since-epoch."""
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, np.datetime64):
        return int(value.astype("datetime64[D]").astype(np.int64))
    if isinstance(value, _dt.datetime):
        value = value.date()
    if isinstance(value, _dt.date):
        return (value - _dt.date(1970, 1, 1)).days
    s = str(value).strip()[:10]
    y, m, d = (int(p) for p in s.split("-"))
    return days_from_civil(y, m, d)


def date_literal_to_millis(value) -> int:
    if isinstance(value, str) and ("T" in value or " " in value.strip()):
        value = _dt.datetime.fromisoformat(
            value.strip().replace("Z", "+00:00"))
    if isinstance(value, _dt.datetime):
        # keep sub-day precision (flooring a timestamp literal to days
        # would silently widen filters)
        if value.tzinfo is not None:
            value = value.astimezone(_dt.timezone.utc).replace(tzinfo=None)
        return int((value - _dt.datetime(1970, 1, 1))
                   .total_seconds() * 1000)
    if isinstance(value, np.datetime64):
        return int(value.astype("datetime64[ms]").astype(np.int64))
    return date_literal_to_days(value) * MILLIS_PER_DAY


def literal_is_zoned(value) -> bool:
    """True when a time literal carries an EXPLICIT zone/offset — it is
    then an absolute instant and must NOT be re-shifted by the session
    timezone."""
    if isinstance(value, _dt.datetime):
        return value.tzinfo is not None
    if isinstance(value, str):
        s = value.strip()
        if "T" in s or " " in s:
            try:
                return _dt.datetime.fromisoformat(
                    s.replace("Z", "+00:00")).tzinfo is not None
            except ValueError:
                return False
    return False


def literal_to_utc_millis(value, tz: str) -> int:
    """The ONE policy for time-literal lowering: zoned literals are
    absolute instants; naive ones mean session-local wall clock."""
    ms = date_literal_to_millis(value)
    from spark_druid_olap_tpu_torch.ops import timezone as TZ
    if not TZ.is_utc(tz) and not literal_is_zoned(value):
        ms = TZ.local_naive_to_utc_millis(tz, ms)
    return ms


# -- field extraction ---------------------------------------------------------

def extract_field(field: str, days, ms_in_day=None):
    """Extract a calendar field from int32 day numbers."""
    days = _t(days)
    if field == "epoch_day":
        return days
    if field in ("year", "month", "day", "quarter"):
        y, m, d = civil_from_days(days)
        if field == "year":
            return y
        if field == "month":
            return m
        if field == "day":
            return d
        return _fdiv(m - 1, 3) + 1
    if field == "dow":
        # ISO: Monday=1..Sunday=7; day 0 (1970-01-01) was a Thursday
        return torch.remainder(days + 3, 7) + 1
    if field == "doy":
        y, _, _ = civil_from_days(days)
        return days - days_of_jan1(y) + 1
    if field == "week":
        # week index since epoch, Monday-aligned (for bucketing, not ISO week#)
        return _fdiv(days + 3, 7)
    ms_in_day = None if ms_in_day is None else _t(ms_in_day)
    if field == "hour":
        assert ms_in_day is not None
        return _fdiv(ms_in_day, 3_600_000)
    if field == "minute":  # minute-of-hour (SQL EXTRACT semantics)
        assert ms_in_day is not None
        return torch.remainder(_fdiv(ms_in_day, 60_000), 60)
    if field == "second":  # second-of-minute
        assert ms_in_day is not None
        return torch.remainder(_fdiv(ms_in_day, 1000), 60)
    raise ValueError(f"unsupported time field {field!r}")


def days_of_jan1(y):
    """days-since-epoch of January 1st of year ``y`` (vectorized)."""
    yp = _t(y) - 1
    d = 365 * yp + _fdiv(yp, 4) - _fdiv(yp, 100) + _fdiv(yp, 400) + 1
    return d - 719163  # days from 0000-01-01 to 1970-01-01 is 719162 (+1 offset)


def year_month_index(days):
    """Monotone month index (year*12 + month-1): an order-preserving
    month-granularity bucket id that is cheap to decode."""
    y, m, _ = civil_from_days(days)
    return y * 12 + (m - 1)


# -- granularity bucketing ----------------------------------------------------

def bucket_and_cardinality(kind: str, days, ms_in_day, min_day: int,
                           max_day: int, duration_millis=None):
    """Map each row to a dense granularity-bucket id in [0, card).

    Returns (bucket int32 tensor, card, decode) where ``decode(idx)`` is a
    host-side function from bucket id -> representative epoch-millis (bucket
    start), used to materialize the output time column.
    """
    days = _t(days)
    ms_in_day = None if ms_in_day is None else _t(ms_in_day)
    if kind == "all":
        return torch.zeros_like(days), 1, \
            lambda i: np.int64(min_day) * MILLIS_PER_DAY
    if kind == "day":
        card = max_day - min_day + 1
        return days - min_day, card, \
            lambda i: (np.int64(i) + min_day) * MILLIS_PER_DAY
    if kind == "week":
        lo = (min_day + 3) // 7
        hi = (max_day + 3) // 7
        card = hi - lo + 1
        return _fdiv(days + 3, 7) - lo, card, \
            lambda i: (np.int64(i + lo) * 7 - 3) * MILLIS_PER_DAY
    if kind == "month":
        lo = _host_year_month_index(min_day)
        hi = _host_year_month_index(max_day)
        card = hi - lo + 1
        return year_month_index(days) - lo, card, \
            lambda i: _month_index_to_millis(int(i) + lo)
    if kind == "quarter":
        lo = _host_year_month_index(min_day) // 3
        hi = _host_year_month_index(max_day) // 3
        card = hi - lo + 1
        return _fdiv(year_month_index(days), 3) - lo, card, \
            lambda i: _month_index_to_millis((int(i) + lo) * 3)
    if kind == "year":
        y_lo = _host_civil(min_day)[0]
        y_hi = _host_civil(max_day)[0]
        card = y_hi - y_lo + 1
        y, _, _ = civil_from_days(days)
        return y - y_lo, card, \
            lambda i: np.int64(days_from_civil(int(i) + y_lo, 1, 1)) \
            * MILLIS_PER_DAY
    if kind == "hour":
        lo = min_day * 24
        card = (max_day + 1) * 24 - lo
        b = days * 24 + _fdiv(ms_in_day, 3_600_000) - lo
        return b, card, lambda i: (np.int64(i) + lo) * 3_600_000
    if kind == "minute":
        lo = min_day * 1440
        card = (max_day + 1) * 1440 - lo
        b = days * 1440 + _fdiv(ms_in_day, 60_000) - lo
        return b, card, lambda i: (np.int64(i) + lo) * 60_000
    if kind == "duration":
        assert duration_millis is not None
        g = int(duration_millis)
        if g % MILLIS_PER_DAY == 0:
            gd = g // MILLIS_PER_DAY
            lo = min_day // gd
            card = max_day // gd - lo + 1
            return _fdiv(days, gd) - lo, card, \
                lambda i: (np.int64(i) + lo) * gd * MILLIS_PER_DAY
        if MILLIS_PER_DAY % g == 0:
            per_day = MILLIS_PER_DAY // g
            lo = min_day * per_day
            card = (max_day + 1) * per_day - lo
            b = days * per_day + _fdiv(ms_in_day, g) - lo
            return b, card, lambda i: (np.int64(i) + lo) * g
        raise ValueError(
            f"duration {g}ms neither divides nor is divisible by a day; "
            "unsupported on the int32 device path")
    raise ValueError(f"unsupported granularity {kind!r}")


def _host_civil(day: int):
    d = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(day))
    return d.year, d.month, d.day


def _host_year_month_index(day: int) -> int:
    y, m, _ = _host_civil(day)
    return y * 12 + (m - 1)


def _month_index_to_millis(idx: int) -> np.int64:
    y, m = divmod(int(idx), 12)
    return np.int64(days_from_civil(y, m + 1, 1)) * MILLIS_PER_DAY


GRANULARITY_FIELDS = {"year": "year", "quarter": "quarter", "month": "month",
                      "week": "week", "day": "day", "hour": "hour",
                      "minute": "minute"}
