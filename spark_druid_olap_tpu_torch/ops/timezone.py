"""Session timezone support.

Port of ``spark_druid_olap_tpu/ops/timezone.py``. Host helpers are copied
unchanged; :func:`shift_days_ms` runs on torch tensors.

Time is stored as UTC (days + ms-in-day int32 pairs); a non-UTC session
shifts each row to LOCAL wall-clock time before bucketing/field extraction
via a per-UTC-day offset LUT. The LUT holds the zone's UTC offset at each
UTC day start: exact for all fixed-offset zones, and exact for DST zones
everywhere except rows inside the one transition hour itself.
"""

from __future__ import annotations

import datetime
import functools

import numpy as np
import torch

MILLIS_PER_DAY = 86_400_000


def is_utc(tz_id) -> bool:
    return not tz_id or str(tz_id).upper() in ("UTC", "Z", "GMT", "ETC/UTC",
                                               "ETC/GMT", "+00:00", "UTC+0")


@functools.lru_cache(maxsize=32)
def _zone(tz_id: str):
    if tz_id.startswith(("+", "-")):
        # fixed-offset spelling ±HH:MM
        sign = 1 if tz_id[0] == "+" else -1
        hh, mm = tz_id[1:].split(":") if ":" in tz_id else (tz_id[1:], "0")
        return datetime.timezone(
            sign * datetime.timedelta(hours=int(hh), minutes=int(mm)))
    from zoneinfo import ZoneInfo
    return ZoneInfo(tz_id)


@functools.lru_cache(maxsize=64)
def day_offset_lut(tz_id: str, min_day: int, max_day: int) -> np.ndarray:
    """UTC offset (ms, int32) at each UTC day start in [min_day, max_day]."""
    zone = _zone(tz_id)
    n = max(1, max_day - min_day + 1)
    out = np.empty(n, np.int32)
    for i in range(n):
        dt = datetime.datetime.fromtimestamp(
            (min_day + i) * 86_400, tz=datetime.timezone.utc)
        out[i] = int(zone.utcoffset(dt).total_seconds() * 1000)
    out.setflags(write=False)
    return out


def local_naive_to_utc_millis(tz_id: str, naive_ms: int) -> int:
    """UTC instant of a local wall-clock millisecond value (used for date
    literals in WHERE: `ts >= date '1994-01-01'` means local midnight)."""
    dt = (datetime.datetime(1970, 1, 1)
          + datetime.timedelta(milliseconds=int(naive_ms)))
    off = _zone(tz_id).utcoffset(dt.replace(tzinfo=_zone(tz_id)))
    return int(naive_ms) - int(off.total_seconds() * 1000)


def shift_days_ms(days: torch.Tensor, ms_in_day: torch.Tensor,
                  lut: np.ndarray, base_day: int):
    """UTC (days, ms_in_day) -> LOCAL (days, ms_in_day), int32 tensors."""
    idx = torch.clamp(days - base_day, 0, len(lut) - 1).long()
    off = torch.as_tensor(np.array(lut), device=days.device)[idx]
    tot = ms_in_day + off
    dsh = torch.div(tot, MILLIS_PER_DAY, rounding_mode="floor")
    return days + dsh, tot - dsh * MILLIS_PER_DAY


def shift_millis_np(ms: np.ndarray, tz_id: str) -> np.ndarray:
    """Host: UTC epoch-ms -> local wall-clock ms (numpy)."""
    if len(ms) == 0 or is_utc(tz_id):
        return np.asarray(ms, np.int64)
    ms = np.asarray(ms, np.int64)
    day = np.floor_divide(ms, MILLIS_PER_DAY)
    lo, hi = int(day.min()), int(day.max())
    if hi - lo > 400_000:      # ~1100 years: sentinel/garbage timestamps
        raise ValueError(
            f"timezone shift over an implausible day range [{lo}, {hi}]")
    lut = day_offset_lut(tz_id, lo, hi)
    return ms + lut[(day - lo).astype(np.int64)]
