"""Scan context: the bridge between host-side metadata (dictionaries, column
kinds) and the device tensors a query scans.

Port of ``spark_druid_olap_tpu/ops/scan.py`` (``ScanContext``, the
late-materialization view ``CompactScanContext``, ``array_names``,
``array_dtype``, ``build_array`` and, for a wave, ``build_wave_array``;
no tiered or multi-host builders). The
tensors it holds live on the engine's device; the dictionaries and
cardinalities it consults stay on the host, so no string ever reaches the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from spark_druid_olap_tpu_torch.segment.column import ColumnKind
from spark_druid_olap_tpu_torch.segment.store import Datasource

TIME_MS_KEY = "__time_ms__"
ROW_VALID_KEY = "__rows__"
NULL_VALID_PREFIX = "__nulls__"

_NARROW_INTS = (torch.int8, torch.int16, torch.uint8)


@dataclasses.dataclass
class ScanContext:
    """Host metadata + bound device tensors for one scan."""

    ds: Datasource
    arrays: Dict[str, torch.Tensor]    # name -> [S, R] tensor
    min_day: int                       # over the selected segments
    max_day: int
    tz: str = "UTC"                    # session timezone (instants shift)

    @property
    def device(self) -> torch.device:
        return self.arrays[ROW_VALID_KEY].device

    # -- device array access --------------------------------------------------
    def col(self, name: str) -> torch.Tensor:
        if name not in self.arrays:
            raise KeyError(
                f"column {name!r} not bound into this scan "
                f"(bound: {sorted(self.arrays)})")
        arr = self.arrays[name]
        if arr.dtype in _NARROW_INTS:
            # narrow storage (i8/i16 codes and small longs) widens on
            # read: device memory holds the narrow bytes, kernels see i32
            arr = arr.to(torch.int32)
        return arr

    def row_valid(self) -> torch.Tensor:
        return self.arrays[ROW_VALID_KEY]

    def time_ms(self) -> Optional[torch.Tensor]:
        return self.arrays.get(TIME_MS_KEY)

    def null_valid(self, name: str) -> Optional[torch.Tensor]:
        """Validity mask for a nullable column, or None if non-nullable."""
        return self.arrays.get(NULL_VALID_PREFIX + name)

    # -- host metadata --------------------------------------------------------
    def kind(self, name: str) -> ColumnKind:
        return self.ds.column_kind(name)

    def dictionary(self, name: str) -> np.ndarray:
        return self.ds.dims[name].dictionary


def compact_keep(valid: torch.Tensor, m: int):
    """Late materialization's row order: ``(keep, n_live)``, where
    ``keep`` ([m] int64) lists the flat positions of the rows where
    ``valid`` holds in ascending order, then the other rows in ascending
    order, cut to ``m``; ``n_live`` is the live-row count, a 0-d device
    tensor. It is the order of the JAX package's ``lax.sort`` of
    ``(valid ? 0 : 1, row index)``, built as a stable partition (one
    cumulative sum and one scatter): nothing waits on the host."""
    flat = valid.reshape(-1)
    n = flat.numel()
    ridx = torch.arange(n, device=flat.device)
    c = torch.cumsum(flat, 0)
    n_live = c[-1]
    # a live row's place is the live rows before it; a dead row's is
    # after every live row, behind the dead rows before it (ridx - c)
    pos = torch.where(flat, c - 1, n_live + ridx - c)
    keep = torch.empty_like(ridx).scatter_(0, pos, ridx)
    return keep[:m], n_live


@dataclasses.dataclass
class CompactScanContext(ScanContext):
    """Late-materialization view over a scan: after the filter mask is
    evaluated on the full [S, R] arrays, the surviving row positions move
    to a static [M] prefix (``keep``, :func:`compact_keep`) and every
    later column access gathers through it, so group keys, values and the
    aggregation run at O(M) instead of O(N). Each column is gathered once
    (cached per name), in its storage width, and widened after."""

    keep: Optional[torch.Tensor] = None   # int64 [M] flat row positions

    def __post_init__(self):
        self._cache: Dict[str, torch.Tensor] = {}

    def _gather(self, key: str, arr: torch.Tensor) -> torch.Tensor:
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = arr.reshape(-1)[self.keep]
        return hit

    def col(self, name: str) -> torch.Tensor:
        if name not in self.arrays:
            return super().col(name)          # raises the scan's KeyError
        arr = self._gather(name, self.arrays[name])
        return arr.to(torch.int32) if arr.dtype in _NARROW_INTS else arr

    def row_valid(self) -> torch.Tensor:
        return self._gather(ROW_VALID_KEY, super().row_valid())

    def time_ms(self) -> Optional[torch.Tensor]:
        t = super().time_ms()
        return None if t is None else self._gather(TIME_MS_KEY, t)

    def null_valid(self, name: str) -> Optional[torch.Tensor]:
        nv = super().null_valid(name)
        return None if nv is None else self._gather(
            NULL_VALID_PREFIX + name, nv)


def array_names(ds: Datasource, columns, need_time_ms: bool):
    """The array keys a scan over ``columns`` binds."""
    names = list(columns)
    for name in columns:
        col = ds.dims.get(name) or ds.metrics.get(name)
        if col is not None and col.has_nulls():
            names.append(NULL_VALID_PREFIX + name)
    if need_time_ms and ds.time is not None:
        names.append(TIME_MS_KEY)
    names.append(ROW_VALID_KEY)
    return names


def array_dtype(ds: Datasource, key: str):
    """Host dtype of one stacked array."""
    if key == ROW_VALID_KEY or key.startswith(NULL_VALID_PREFIX):
        return np.bool_
    if key == TIME_MS_KEY:
        return ds.time.ms_dtype()
    if key in ds.dims:
        return ds.dims[key].data_dtype()
    if key in ds.metrics:
        return ds.metrics[key].data_dtype()
    if ds.time is not None and key == ds.time.name:
        return ds.time.data_dtype()
    return np.int32


def _stacked_by_key(ds: Datasource, key: str) -> np.ndarray:
    """The [S, R] stacked array behind one array key."""
    if key == ROW_VALID_KEY:
        return ds.stacked_row_validity()
    if key == TIME_MS_KEY:
        return ds.stacked_time_ms()
    if key.startswith(NULL_VALID_PREFIX):
        return ds.stacked_null_validity(key[len(NULL_VALID_PREFIX):])
    return ds.stacked(key)


def build_array(ds: Datasource, key: str,
                segment_indices: Optional[np.ndarray] = None) -> np.ndarray:
    """Materialize one host-side stacked array by key over the (pruned)
    ``segment_indices``. Unlike the JAX engine, which pads the segment
    axis to a power of two for its compile cache, the port binds exactly
    the selected segments: eager PyTorch has no compiled shape to keep
    stable."""
    arr = _stacked_by_key(ds, key)
    if segment_indices is not None and (
            len(segment_indices) != ds.num_segments
            or not np.array_equal(segment_indices,
                                  np.arange(ds.num_segments))):
        arr = arr[segment_indices]
    return arr


def build_wave_array(ds: Datasource, key: str, segment_indices,
                     out: np.ndarray) -> np.ndarray:
    """One wave's host array of ``key``, built into ``out`` ([spw, R] of
    the array's dtype): the selected segments, then zero segments up to
    ``spw``, whose ``row_valid`` is false (the JAX package's
    ``build_array(ds, key, segs, pad_segments_to=spw)``). Every wave thus
    has the shape its program was built for, and ``out`` may be a pinned
    staging buffer that the copy to the device reads."""
    n = len(segment_indices)
    np.take(_stacked_by_key(ds, key), segment_indices, axis=0, out=out[:n],
            mode="clip")
    out[n:] = 0
    return out
