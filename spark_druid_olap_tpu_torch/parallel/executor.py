"""Query executor: lowers a QuerySpec onto device tensors and the group-by
tiers.

Port of ``spark_druid_olap_tpu/parallel/executor.py``: ``QueryEngine.execute``
(query-id registration, the in-flight registry and WLM admission,
``wlm/``) -> ``_execute_admitted`` (the semantic result cache,
``cache/``, then, on a cluster broker, the scatter of ``cluster``, the
``cluster/broker.ClusterClient`` a broker's ``Context`` attaches, then
the shared-scan coalescer) -> ``_execute_inner``
-> ``_run_agg`` for GroupBy, Timeseries and TopN specs, ``_run_select``
and ``_run_search`` for raw-row and dictionary searches, on one device.
A cancel (``cancel``) or a deadline (``QueryContext.timeout_millis``)
takes effect at the host's stage boundaries (``_stage_check``): before
each dispatch, after the device round trip, and at every wave; a
launched kernel runs to its end. Planning (``plan_dimension``,
``plan_aggregation`` / ``AggPlan``, ``_plan_agg``, ``_plan_routes``), the
scan cores (``_make_core``, ``_hash_core``), the device-resident array
cache (``_bind_arrays``), decode and the host epilogue
(``_agg_epilogue``) mirror the JAX engine.

Tiers, as the JAX engine picks them: the dense route up to
``sdot.engine.groupby.dense.max.keys`` (the fused kernel for small K, the
scatter tier above it); the hashed tier above that ceiling
(``_run_agg_hashed``: one slot sort, then the sorted-run or the scatter
aggregation, table compaction for large tables, a 4x retry on overflow);
and the medium-K reroute of dense key spaces onto the sorted-run tier
when the sorted-run gate says so. An ordered limit over a large key space
selects its candidates on the device (device top-k, dense and hashed),
and a GroupBy re-runs without it when the exactness proof fails. A
selective filter over a large scan compacts its survivors to a static
prefix first (late materialization, ``_plan_compact_m``; dense and
hashed, with the uncompacted retry when the budget overflows), and an
exact-comparable HAVING over a large dense key space filters on the
device (``_plan_device_having``: two dispatches, only the passing groups
travel). A select filters on the device and moves a bit-packed row mask.

Dimensions cover plain columns, time extractions, granularity buckets and
the dictionary-functional lookup / regex / expression extractions.
Sketch aggregates (HLL ``cardinality``, theta ``thetasketch``, KLL
``quantile``) run on the dense route as register ops after the dense
group-by (``ops/hll.py``, ``ops/theta.py``, ``ops/kll.py``); their
registers travel with the finals and are estimated on the host, or, on a
cluster historical (``partial_sketches``), ship raw for the broker's
register merge.

A scan whose bound arrays pass the per-device wave budget
(``parallel/cost.wave_budget_bytes``, ``sdot.engine.wave.max.bytes``)
runs as bounded waves of segments (``_run_waves`` on the dense route, the
same loop in ``_run_agg_hashed``; ``_WaveBinder``): one launch of the
scan's program per wave, the next wave's copy to the device in flight
while the current wave computes, each wave's finals merged on the host
(``_merge_wave_finals``, ``_merge_hash_partials``). Waves bypass the bind
cache; device top-k and device HAVING stay off under waves, as in the JAX
engine. On a tiered datasource (``tier/``) ``execute`` pins every chunk the
statement faults until it ends, binds fault only the segments being bound
(``ops/scan.build_array`` / ``build_wave_array``), the wave binder pins a
wave's chunks only while it copies them into its staging
(``TieredDatasource.wave_pins``), and each wave enqueues the chunks of the
wave after next on the tier's prefetcher.

A device loss demotes the statement and every later one to the host tier
(``EngineFallback`` ``backend_lost``), with at most one bounded re-attach
probe per cooldown (``_try_reattach``). An error is a loss when its text
reads as a sticky CUDA error (``_is_backend_loss``) and a probe of the
device then fails (``_probe_device_alive``); where it surfaced
(``_loss_site``) goes into ``last_stats["backend_lost"]``. Every path the
JAX engine would take outside the port so far — multi-host partial stores —
raises ``NotImplementedError`` naming its ROADMAP item; the engine never
changes an answer to stay inside the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import expr_compile as EC
from spark_druid_olap_tpu_torch.ops import filters as F
from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops import hash_groupby as H
from spark_druid_olap_tpu_torch.ops import sorted_groupby as SG
from spark_druid_olap_tpu_torch.ops import time_ops as T
from spark_druid_olap_tpu_torch.ops import timezone as TZ
from spark_druid_olap_tpu_torch.ops.kll import merge as kll_merge
from spark_druid_olap_tpu_torch.ops.scan import (
    CompactScanContext,
    ScanContext,
    array_dtype,
    array_names,
    build_array,
    build_wave_array,
    compact_keep,
)
from spark_druid_olap_tpu_torch.ops.sketch import (
    SKETCH_KINDS,
    decode_sketch,
    sketch_registers,
)
from spark_druid_olap_tpu_torch.parallel import cost as C
from spark_druid_olap_tpu_torch.parallel.cost import unit_cost
from spark_druid_olap_tpu_torch.planner import fusion as FU
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.segment.column import ColumnKind
from spark_druid_olap_tpu_torch.segment.store import Datasource, SegmentStore
from spark_druid_olap_tpu_torch.utils import host_eval
from spark_druid_olap_tpu_torch.utils import phases as PH
from spark_druid_olap_tpu_torch.utils.config import (
    BACKEND_RETRY_SECONDS,
    COST_FUSED_ROW,
    COST_GATHER_PROBE,
    COST_SCATTER_UPDATE,
    COST_SCATTER_UPDATE_BIG,
    COST_SORT_PAYLOAD_ROW,
    COST_SORT_ROW,
    COST_TABLE_CACHE_BYTES,
    Config,
    DEVICE_CACHE_BYTES,
    GROUPBY_DENSE_MAX_KEYS,
    GROUPBY_HASH_COMPACT_MIN,
    GROUPBY_HASH_MAX_SLOTS,
    GROUPBY_HASH_MAX_SLOTS_CPU,
    GROUPBY_HASH_SLOTS,
    GROUPBY_HASH_SORTED,
    GROUPBY_PALLAS_MAX_KEYS,
    GROUPBY_SORTED_MIN_KEYS,
    HAVING_DEVICE_MIN_KEYS,
    HLL_LOG2M,
    QUANTILE_LANES,
    SCAN_COMPACT,
    SCAN_COMPACT_MIN_ROWS,
    SELECT_DEVICE_MIN_ROWS,
    SHAREDSCAN_FUSION_ENABLED,
    TOPN_DEVICE_MIN_KEYS,
    TZ_ID,
)


class EngineFallback(Exception):
    """Query (or part) can't run on the device path; a planner must evaluate
    a host residual instead."""


class QueryCancelled(RuntimeError):
    """Raised when a registered query id is cancelled mid-flight. The
    cancel is cooperative: it takes effect at the next stage boundary on
    the host (before a dispatch, after the device round trip, at every
    wave); a launched kernel runs to its end."""


class QueryTimeout(RuntimeError):
    """Raised when QueryContext.timeout_millis elapses at a stage boundary."""


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} not ported yet (ROADMAP {item})")


# =============================================================================
# dimension planning (host side; card/decode known before the scan)
# =============================================================================

@dataclasses.dataclass
class DimPlan:
    output_name: str
    card: int
    build: object            # ctx -> int32 codes in [0, card)
    decode: object           # np.ndarray[int] -> np.ndarray of output values
    source_cols: tuple


def _with_null_slot(build, decode, card, name, nullable):
    """Nullable grouping columns get slot 0 = the null group; non-null codes
    shift by one."""
    if not nullable:
        return build, decode, card

    def build2(ctx):
        nv = ctx.null_valid(name)
        codes = build(ctx)
        if nv is None:
            return codes + 1
        return torch.where(nv, codes + 1, 0)

    def decode2(idx):
        idx = np.asarray(idx, np.int64)
        vals = decode(np.maximum(idx - 1, 0))
        out = np.empty(len(idx), dtype=object)
        out[:] = [None if i == 0 else v for i, v in zip(idx, vals)]
        return out

    return build2, decode2, card + 1


def _plan_plain(name: str, ds: Datasource, out: str) -> DimPlan:
    kind = ds.column_kind(name)
    if kind == ColumnKind.DIM:
        col = ds.dims[name]
        build, decode, card = _with_null_slot(
            lambda ctx: ctx.col(name),
            lambda idx: col.dictionary[np.asarray(idx, np.int64)],
            col.cardinality, name, col.validity is not None)
        return DimPlan(out, card, build, decode, (name,))
    if kind in (ColumnKind.DATE, ColumnKind.LONG):
        m = ds.metrics[name]
        lo = int(m.min) if m.min is not None else 0
        hi = int(m.max) if m.max is not None else 0
        if kind == ColumnKind.DATE:
            dec = lambda idx: (np.asarray(idx, np.int64) + lo) \
                .astype("datetime64[D]")
        else:
            if hi - lo + 1 >= H.PART_LIMIT:
                raise EngineFallback(f"grouping on wide-range long {name}")
            dec = lambda idx: np.asarray(idx, np.int64) + lo
        build, decode, card = _with_null_slot(
            lambda ctx: ctx.col(name) - lo, dec, hi - lo + 1, name,
            m.validity is not None)
        return DimPlan(out, card, build, decode, (name,))
    if kind == ColumnKind.TIME:
        raise EngineFallback("group by raw time column; use an extraction")
    raise EngineFallback(f"group by {kind}")


_FIELD_CARDS = {"month": (1, 12), "quarter": (1, 4), "day": (1, 31),
                "dow": (1, 7), "doy": (1, 366), "hour": (0, 23),
                "minute": (0, 59), "second": (0, 59)}


def _plan_time_extraction(dspec: S.DimensionSpec, ds: Datasource,
                          min_day: int, max_day: int,
                          tz: str = "UTC") -> DimPlan:
    ex = dspec.extraction
    name = dspec.dimension
    kind = ds.column_kind(name)
    if kind not in (ColumnKind.TIME, ColumnKind.DATE, ColumnKind.DIM):
        raise EngineFallback(f"time extraction over {kind}")
    if kind == ColumnKind.DIM:
        # date-string dim: convert through host LUT then treat as days
        col = ds.dims[name]
        lut = np.array([T.date_literal_to_days(s) if s else 0
                        for s in col.dictionary], dtype=np.int32)
        day_build = lambda ctx: EC.take1d(lut, ctx.col(name))
        lo_day, hi_day = int(lut.min()), int(lut.max())
    elif kind == ColumnKind.DATE:
        m = ds.metrics[name]
        lo_day = int(m.min) if m.min is not None else 0
        hi_day = int(m.max) if m.max is not None else 0
        day_build = lambda ctx: ctx.col(name)
    elif not TZ.is_utc(tz):
        # instants: shift to session-local wall-clock before extraction
        lo_day, hi_day = min_day - 1, max_day + 1
        _tzlut = TZ.day_offset_lut(tz, lo_day, hi_day)

        def dt_build(ctx):
            return TZ.shift_days_ms(ctx.col(name), ctx.time_ms(), _tzlut,
                                    lo_day)

        day_build = lambda ctx: dt_build(ctx)[0]
    else:
        lo_day, hi_day = min_day, max_day
        day_build = lambda ctx: ctx.col(name)
    if kind == ColumnKind.TIME and not TZ.is_utc(tz):
        ms_build = lambda ctx: dt_build(ctx)[1]
    elif kind == ColumnKind.TIME:
        ms_build = lambda ctx: ctx.time_ms()
    else:
        ms_build = lambda ctx: None

    field = ex.field
    if field.startswith("trunc_"):
        grain = field[len("trunc_"):]

        def build(ctx, grain=grain):
            b, _, _ = T.bucket_and_cardinality(grain, day_build(ctx),
                                               ms_build(ctx), lo_day, hi_day)
            return b
        _, card, decode1 = T.bucket_and_cardinality(
            grain, np.zeros(1, np.int32), np.zeros(1, np.int32),
            lo_day, hi_day)
        decode = lambda idx: np.array([decode1(i) for i in np.asarray(idx)],
                                      dtype="datetime64[ms]")
        return DimPlan(dspec.output_name, card, build, decode, (name,))
    if field == "year":
        y_lo = host_eval._civil(np.array([lo_day]))[0][0]
        y_hi = host_eval._civil(np.array([hi_day]))[0][0]
        return DimPlan(dspec.output_name, int(y_hi - y_lo + 1),
                       lambda ctx: T.extract_field("year", day_build(ctx))
                       - int(y_lo),
                       lambda idx: np.asarray(idx, np.int64) + int(y_lo),
                       (name,))
    if field == "week":
        lo = (lo_day + 3) // 7
        hi = (hi_day + 3) // 7
        return DimPlan(dspec.output_name, hi - lo + 1,
                       lambda ctx: T.extract_field("week", day_build(ctx))
                       - lo,
                       lambda idx: ((np.asarray(idx, np.int64) + lo) * 7 - 3)
                       .astype("datetime64[D]"), (name,))
    if field in _FIELD_CARDS:
        f_lo, f_hi = _FIELD_CARDS[field]
        if field in ("hour", "minute", "second") and kind != ColumnKind.TIME:
            raise EngineFallback(f"{field} of a date column")

        def build(ctx, field=field, f_lo=f_lo):
            return T.extract_field(field, day_build(ctx),
                                   ms_build(ctx)) - f_lo
        return DimPlan(dspec.output_name, f_hi - f_lo + 1, build,
                       lambda idx: np.asarray(idx, np.int64) + f_lo, (name,))
    raise EngineFallback(f"time extraction field {field}")


def plan_granularity_dim(gran: S.Granularity, ds: Datasource, min_day: int,
                         max_day: int, tz: str = "UTC") -> DimPlan:
    """Granularity bucketing as a leading group dimension named 'timestamp'.
    Non-UTC sessions bucket in LOCAL wall-clock time and label buckets with
    their local start."""
    if ds.time is None:
        raise EngineFallback("granularity on time-less datasource")
    tname = ds.time.name
    kind = gran.kind
    if kind == "none":
        raise EngineFallback("'none' granularity (row-grain) on agg path")
    shift = not TZ.is_utc(tz)
    lo_day, hi_day = (min_day - 1, max_day + 1) if shift \
        else (min_day, max_day)
    tzlut = TZ.day_offset_lut(tz, lo_day, hi_day) if shift else None
    try:
        _, card, decode1 = T.bucket_and_cardinality(
            kind, np.zeros(1, np.int32), np.zeros(1, np.int32),
            lo_day, hi_day, gran.duration_millis)
    except ValueError as e:
        raise EngineFallback(str(e))

    def build(ctx):
        days, ms = ctx.col(tname), ctx.time_ms()
        if shift:
            days, ms = TZ.shift_days_ms(days, ms, tzlut, lo_day)
        b, _, _ = T.bucket_and_cardinality(
            kind, days, ms, lo_day, hi_day, gran.duration_millis)
        return b

    decode = lambda idx: np.array([decode1(i) for i in np.asarray(idx)],
                                  dtype="datetime64[ms]")
    return DimPlan("timestamp", card, build, decode, (tname,))


def _plan_expr_extraction(dspec: S.DimensionSpec, ds: Datasource) -> DimPlan:
    ex = dspec.extraction
    cols = sorted(E.columns_in(ex.expr))
    # single string-dim expression: evaluate over the dictionary domain on
    # host, factorize, remap codes through a LUT (dictionary-functional path)
    if len(cols) == 1 and cols[0] in ds.dims:
        dim = ds.dims[cols[0]]
        try:
            vals = host_eval.eval_expr(ex.expr, {cols[0]: dim.dictionary})
        except host_eval.HostEvalError as e:
            raise EngineFallback(str(e))
        vals = np.asarray(vals)
        if vals.shape != dim.dictionary.shape:
            raise EngineFallback("non-elementwise dim expression")
        uniq, remap = np.unique(vals.astype(object) if vals.dtype == object
                                else vals, return_inverse=True)
        lut = remap.astype(np.int32)
        name = cols[0]
        return DimPlan(dspec.output_name, len(uniq),
                       lambda ctx: EC.take1d(lut, ctx.col(name)),
                       lambda idx: uniq[np.asarray(idx, np.int64)],
                       (name,))
    # general expression: compiled on the device; needs a declared small
    # integer range
    card = ex.cardinality
    if card is None:
        raise EngineFallback(
            "expression dimension without cardinality bound "
            f"({E.to_sql(ex.expr)})")

    def build(ctx):
        v = EC.compile_expr(ex.expr, ctx)
        if isinstance(v, EC.BoolValue):
            return v.arr.to(torch.int32)
        if isinstance(v, EC.NumValue) and not v.is_float:
            return torch.clamp(v.arr, 0, card - 1)
        raise EC.Unsupported("expression dimension must be int/bool")

    return DimPlan(dspec.output_name, card, build,
                   lambda idx: np.asarray(idx, np.int64), tuple(cols))


def _plan_dict_transform(dspec: S.DimensionSpec, ds: Datasource,
                         vals_fn) -> DimPlan:
    """Dictionary-functional extraction: apply ``vals_fn`` to the dim's
    dictionary on host (None entries = null), factorize, and remap codes
    through a LUT on the device. Null output (and null input rows) land in
    slot 0."""
    name = dspec.dimension
    if ds.column_kind(name) != ColumnKind.DIM:
        raise EngineFallback("lookup/regex extraction over non-string column")
    dim = ds.dims[name]
    vals = vals_fn(dim.dictionary)
    null_mask = np.array([v is None for v in vals], dtype=bool)
    uniq = np.unique(np.asarray(
        [str(v) for v, nm in zip(vals, null_mask) if not nm], dtype=object)) \
        if (~null_mask).any() else np.empty(0, dtype=object)
    pos = {v: j for j, v in enumerate(uniq)}
    lut = np.array([0 if nm else 1 + pos[str(v)]
                    for v, nm in zip(vals, null_mask)], dtype=np.int32)
    has_nulls = dim.validity is not None

    def build(ctx):
        mapped = EC.take1d(lut, ctx.col(name))
        if has_nulls:
            mapped = torch.where(ctx.null_valid(name), mapped, 0)
        return mapped

    def decode(idx):
        idx = np.asarray(idx, np.int64)
        out = np.empty(len(idx), dtype=object)
        out[:] = [None if i == 0 else uniq[i - 1] for i in idx]
        return out

    return DimPlan(dspec.output_name, len(uniq) + 1, build, decode, (name,))


def _lookup_vals_fn(ex: S.LookupExtraction):
    table = dict(ex.lookup)

    def vals_fn(dictionary):
        out = []
        for s in dictionary:
            if s in table:
                out.append(table[s])
            elif ex.retain_missing:
                out.append(s)
            else:
                out.append(ex.replace_missing_with)
        return out
    return vals_fn


def _regex_vals_fn(ex: S.RegexExtraction):
    import re as _re
    rx = _re.compile(ex.pattern)

    def vals_fn(dictionary):
        out = []
        for s in dictionary:
            m = rx.search(s) if s is not None else None
            if m is not None:
                out.append(m.group(ex.index))
            elif ex.replace_missing:
                out.append(ex.replace_missing_with)
            else:
                out.append(s)
        return out
    return vals_fn


def plan_dimension(dspec: S.DimensionSpec, ds: Datasource, min_day: int,
                   max_day: int, tz: str = "UTC") -> DimPlan:
    try:
        if dspec.extraction is None:
            return _plan_plain(dspec.dimension, ds, dspec.output_name)
        if isinstance(dspec.extraction, S.TimeExtraction):
            return _plan_time_extraction(dspec, ds, min_day, max_day, tz)
        if isinstance(dspec.extraction, S.LookupExtraction):
            return _plan_dict_transform(dspec, ds,
                                        _lookup_vals_fn(dspec.extraction))
        if isinstance(dspec.extraction, S.RegexExtraction):
            return _plan_dict_transform(dspec, ds,
                                        _regex_vals_fn(dspec.extraction))
        if isinstance(dspec.extraction, S.ExprExtraction):
            return _plan_expr_extraction(dspec, ds)
    except EC.Unsupported as e:
        raise EngineFallback(str(e))
    raise EngineFallback(f"extraction {type(dspec.extraction).__name__}")


# =============================================================================
# aggregation planning
# =============================================================================

@dataclasses.dataclass
class AggPlan:
    spec: S.AggregationSpec
    kind: str                    # count|sum|min|max|hll|theta|kll
    out_dtype: object
    source_cols: tuple
    is_int: bool = False         # integer-exact device values (i64 route)
    dim_codes: bool = False      # min/max over a NON-numeric string dim:
    #   aggregate the sorted dictionary's CODES, decode at output

    def build_values(self, ctx: ScanContext, bits: bool = True):
        """The aggregate's values over ``ctx``. HLL and theta hash a DOUBLE
        column's float32 bits, viewed as int32 here; ``bits=False`` keeps
        the float32 column (the wave kernel hashes its bits itself)."""
        a = self.spec
        if a.kind == "anyvalue":
            # FD-demoted grouping column: any row's value works (max); dims
            # contribute their dictionary code, decoded at output
            return ctx.col(a.field)
        if a.field is not None:
            k = ctx.kind(a.field)
            if self.kind in ("hll", "theta"):
                if k in (ColumnKind.DIM, ColumnKind.LONG, ColumnKind.DATE):
                    return ctx.col(a.field)
                if k == ColumnKind.DOUBLE:
                    v = ctx.col(a.field)
                    return v.view(torch.int32) if bits else v
                raise EngineFallback(f"cardinality over {k}")
            if self.kind == "kll":
                # the quantile domain: the numeric values themselves
                # (canonical f32 inside kll_registers)
                if k in (ColumnKind.LONG, ColumnKind.DOUBLE):
                    return ctx.col(a.field)
                raise EngineFallback(f"quantile over {k}")
            if k in (ColumnKind.LONG, ColumnKind.DOUBLE, ColumnKind.DATE):
                return ctx.col(a.field)
            if k == ColumnKind.DIM and self.dim_codes:
                return ctx.col(a.field)          # sorted-dict codes
            if k == ColumnKind.DIM and self.kind in ("min", "max", "sum"):
                # numeric-parsed dim (Druid coerces); host LUT
                lut = np.array([host_eval_try_float(s)
                                for s in ctx.dictionary(a.field)],
                               dtype=np.float32)
                return EC.take1d(lut, ctx.col(a.field))
            raise EngineFallback(f"aggregate {a.kind} over {k}")
        if a.expr is not None:
            return EC._as_num(EC.compile_expr(a.expr, ctx), ctx).arr
        return None

    def build_mask(self, ctx: ScanContext, cse=None):
        """The aggregate's own filter and its columns' validity; ``cse``
        (a ``planner/fusion.CSECache`` over ``ctx``) memoizes the filter
        across a fused group's lanes."""
        a = self.spec
        masks = []
        if a.filter is not None:
            m = cse.lower(a.filter) if cse is not None \
                else F.lower_filter(a.filter, ctx)
            if m is not None:
                masks.append(m)
        cols = [a.field] if a.field is not None else []
        if a.expr is not None:
            cols += list(E.columns_in(a.expr))
        for c in cols:
            nv = ctx.null_valid(c)
            if nv is not None:
                masks.append(nv)
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out


def host_eval_try_float(s):
    try:
        return float(s)
    except (TypeError, ValueError):
        return np.nan


_AGG_KIND = {"count": ("count", np.int64), "longsum": ("sum", np.int64),
             "doublesum": ("sum", np.float64), "longmin": ("min", np.int64),
             "longmax": ("max", np.int64), "doublemin": ("min", np.float64),
             "doublemax": ("max", np.float64),
             "cardinality": ("hll", np.int64),
             "thetasketch": ("theta", np.int64),
             "quantile": ("kll", np.float64),
             "anyvalue": ("max", np.float64)}


def _identity_row(kinds_by_name) -> Dict[str, np.ndarray]:
    """The one identity row of a GLOBAL aggregate over zero rows — SQL
    semantics: count / hll / theta -> 0, sum / min / max / kll -> NULL."""
    return {name: (np.array([0], dtype=np.int64)
                   if kind in ("count", "hll", "theta")
                   else np.array([np.nan]))
            for name, kind in kinds_by_name.items()}


def _col_is_int(ds: Datasource, name: str) -> bool:
    """Whether a column's device values are integers (codes, days, longs)."""
    return ds.column_kind(name) in (ColumnKind.DIM, ColumnKind.LONG,
                                    ColumnKind.DATE, ColumnKind.TIME)


def _expr_is_int(e: E.Expr, ds: Datasource) -> bool:
    """Conservative static integer-ness of an expression's compiled device
    value — drives the exact i64 route for ``sum(case when ...)``-style
    aggregates. It is the integer half of the JAX engine's
    ``_expr_bounds``; the magnitude half only gates that engine's 32-bit
    routes."""
    if isinstance(e, E.Literal):
        return isinstance(e.value, (bool, int))
    if isinstance(e, E.Column):
        # DIM columns lower to f32 parsed-LUT values in expressions
        return ds.column_kind(e.name) != ColumnKind.DIM \
            and _col_is_int(ds, e.name)
    if isinstance(e, E.Cast):
        return e.to in ("int", "long", "integer", "bigint") \
            or _expr_is_int(e.child, ds)
    if isinstance(e, E.BinaryOp):
        return e.op in ("+", "-", "*") and _expr_is_int(e.left, ds) \
            and _expr_is_int(e.right, ds)
    if isinstance(e, E.Case):
        branches = [v for _, v in e.branches] + \
            ([e.otherwise] if e.otherwise is not None else [])
        return all(_expr_is_int(b, ds) for b in branches)
    return isinstance(e, (E.Comparison, E.And, E.Or, E.Not, E.IsNull,
                          E.InList, E.Between, E.Like))


def plan_aggregation(a: S.AggregationSpec, ds: Datasource) -> AggPlan:
    if a.kind not in _AGG_KIND:
        raise EngineFallback(f"aggregation kind {a.kind}")
    kind, dtype = _AGG_KIND[a.kind]
    cols = set()
    is_int = a.kind == "count"
    if a.field is not None and a.kind != "count":
        cols.add(a.field)
        ck = ds.column_kind(a.field)
        if kind == "kll" and ds.time is not None:
            cols.add(ds.time.name)   # the content salt of the sampled set
        if a.kind == "anyvalue" or kind in SKETCH_KINDS:
            is_int = _col_is_int(ds, a.field)
        elif ck == ColumnKind.DIM:
            if kind in ("min", "max") and not _dim_parses_numeric(
                    ds, a.field):
                # lexicographic min/max of a string dim = min/max of its
                # sorted-dictionary codes, decoded at output
                cols |= F.columns_of_filter(a.filter)
                return AggPlan(a, kind, dtype, tuple(sorted(cols)), True,
                               dim_codes=True)
            is_int = False               # numeric-parsed dim: f32 LUT
        else:
            is_int = _col_is_int(ds, a.field)
    if a.expr is not None:
        cols |= E.columns_in(a.expr)
        is_int = _expr_is_int(a.expr, ds)
    cols |= F.columns_of_filter(a.filter)
    return AggPlan(a, kind, dtype, tuple(sorted(cols)), is_int)


def _dim_parses_numeric(ds: Datasource, field: str) -> bool:
    """Whether EVERY dictionary entry of a string dim parses as a number
    (then Druid's numeric-coercion semantics apply to min/max/sum)."""
    d = ds.dims[field].dictionary
    return bool(len(d)) and not np.isnan(np.array(
        [host_eval_try_float(s) for s in d], dtype=np.float64)).any()


def _topk_slack(limit: S.LimitSpec) -> int:
    """Candidate count for a device top-k selection. Secondary order
    columns only reorder ties in the primary metric, so they widen the
    slack."""
    if len(limit.columns) == 1:
        return int(max(2 * limit.limit, limit.limit + 64))
    return int(max(4 * limit.limit, limit.limit + 256))


# =============================================================================
# the engine
# =============================================================================

class QueryEngine:
    def __init__(self, store: SegmentStore, config: Optional[Config] = None,
                 device="cuda"):
        from spark_druid_olap_tpu_torch.cache.result_cache import (
            SemanticResultCache)
        from spark_druid_olap_tpu_torch.metadata.history import (
            InflightRegistry)
        from spark_druid_olap_tpu_torch.parallel.sharedscan import (
            SharedScanCoalescer)
        from spark_druid_olap_tpu_torch.wlm.admit import WorkloadManager
        self.store = store
        self.config = config or Config()
        self.device = torch.device(device)
        self._device_arrays: Dict[tuple, torch.Tensor] = {}
        self._device_bytes = 0
        self._bind_lock = threading.Lock()
        self._tls = threading.local()
        # fused shared-scan programs by signature, built once each
        self._programs: Dict[tuple, object] = {}
        self._compiling: Dict[tuple, threading.Event] = {}
        self._compile_lock = threading.Lock()
        # device-loss state: after a sticky CUDA error statements demote
        # to the host tier, and a bounded re-attach probe runs at most
        # once per cooldown window (``_try_reattach``)
        self._backend_lost_at: Optional[float] = None
        self._backend_lost_site = "?"
        self._backend_retry_at: float = 0.0
        # statement shapes whose late-materialization budget overflowed:
        # their warm runs go straight to the uncompacted program
        self._compact_overflowed: set = set()
        # cooperative cancellation: refcounted flags per query id
        self._cancel_flags: Dict[str, threading.Event] = {}
        self._cancel_refs: Dict[str, int] = {}
        self._cancel_lock = threading.Lock()
        # semantic result cache (cache/): exact and subsumed reuse of
        # aggregate answers held on the host, keyed on the datasource's
        # ingest version
        self.result_cache = SemanticResultCache(self.config)
        # workload management (wlm/): lane admission and tenant quotas in
        # front of every spec; the in-flight registry behind sys_queries
        self.wlm = WorkloadManager(self.config)
        self.inflight = InflightRegistry()
        self.sharedscan = SharedScanCoalescer(self)
        self.wlm.sharedscan = self.sharedscan
        # deterministic fault injection (fault/): None unless
        # sdot.fault.plan is set, and every site guards on None so the
        # un-injected path pays nothing. The WLM site is wired here; the
        # persist manager picks the injector up from this attribute.
        from spark_druid_olap_tpu_torch.fault import FaultInjector
        self.fault = FaultInjector.from_config(self.config)
        self.wlm.fault = self.fault
        # distributed serving tier (cluster/): on a broker this is the
        # scatter/merge client (cluster/broker.py:ClusterClient) wired
        # in by Context; None on single-process engines and historicals
        self.cluster = None
        # historical-node mode (cluster/historical.py): sketch
        # aggregates emit RAW register blocks instead of finalized
        # estimates, so the broker can merge registers across shards
        # and finalize the estimate exactly once
        self.partial_sketches = False

    @property
    def last_stats(self) -> Dict[str, object]:
        """Stats of the calling thread's last query (concurrent queries
        each keep their own)."""
        d = getattr(self._tls, "stats", None)
        if d is None:
            d = self._tls.stats = {}
        return d

    # -- cancellation / timeout -----------------------------------------------
    def register_query(self, query_id: str) -> None:
        """Register a cancellable id BEFORE planning starts, so a cancel
        arriving at any point in the query's life is honored.
        Registrations are refcounted: statements sharing an id (one cancel
        scope) stay cancellable until the LAST one releases."""
        with self._cancel_lock:
            self._cancel_flags.setdefault(query_id, threading.Event())
            self._cancel_refs[query_id] = \
                self._cancel_refs.get(query_id, 0) + 1

    def release_query(self, query_id: str) -> None:
        with self._cancel_lock:
            n = self._cancel_refs.get(query_id, 1) - 1
            if n <= 0:
                self._cancel_refs.pop(query_id, None)
                self._cancel_flags.pop(query_id, None)
            else:
                self._cancel_refs[query_id] = n

    def cancel(self, query_id: str) -> bool:
        """Mark a registered query id cancelled (cooperative; takes effect
        at the next stage boundary). False when the id is not running."""
        ev = self._cancel_flags.get(query_id)
        if ev is None:
            return False
        ev.set()
        return True

    def _stage_check(self, q, t0: float):
        ctxq = getattr(q, "context", None)
        if ctxq is None:
            return
        if ctxq.query_id is not None:
            ev = self._cancel_flags.get(ctxq.query_id)
            if ev is not None and ev.is_set():
                raise QueryCancelled(f"query {ctxq.query_id} cancelled")
        if ctxq.timeout_millis is not None:
            if (_time.perf_counter() - t0) * 1000 > ctxq.timeout_millis:
                raise QueryTimeout(
                    f"query exceeded {ctxq.timeout_millis}ms")

    # -- public ---------------------------------------------------------------
    def execute(self, q: S.QuerySpec) -> QueryResult:
        """Registration, the in-flight registry and WLM admission, then
        ``_execute_admitted``."""
        t0 = _time.perf_counter()
        self.last_stats.clear()
        qid = getattr(getattr(q, "context", None), "query_id", None)
        if qid is not None:
            self.register_query(qid)
        tier = pin_tok = None
        try:
            # tiered cold storage: pin every hot chunk this query faults
            # for its whole lifetime — eviction under budget pressure
            # must never pull a column out from under an in-flight scan
            tier_ds = self.store._datasources.get(
                getattr(q, "datasource", None))
            tier = getattr(tier_ds, "tier", None)
            pin_tok = tier.acquire_pins() if tier is not None else None
            tok = self.inflight.begin(qid, getattr(q, "datasource", None),
                                      type(q).__name__)
            try:
                # the shared-scan coalescer (joined on this thread)
                # annotates each constituent's row with its group id
                self._tls.inflight_tok = tok
                ticket = None
                try:
                    if self.wlm.enabled:
                        # admission before any planning, cache or dispatch
                        # work: a shed query costs nothing, and queue wait
                        # counts against the deadline (t0 is ticking)
                        cancel_ev = self._cancel_flags.get(qid) \
                            if qid is not None else None
                        ticket = self.wlm.admit(self, q, t0, cancel_ev)
                        if ticket.timeout_millis is not None \
                                and getattr(q.context, "timeout_millis",
                                            None) is None:
                            # the lane's default timeout rides the spec so
                            # every _stage_check honors it (the context is
                            # stripped from cache keys and program
                            # signatures)
                            ctx0 = q.context or S.QueryContext()
                            q = dataclasses.replace(
                                q, context=dataclasses.replace(
                                    ctx0,
                                    timeout_millis=ticket.timeout_millis))
                        self.last_stats["wlm"] = ticket.stats()
                        self.inflight.running(tok, lane=ticket.lane,
                                              tenant=ticket.tenant,
                                              queued_ms=ticket.queued_ms)
                    else:
                        self.inflight.running(tok)
                    return self._execute_admitted(q, t0)
                finally:
                    self._tls.inflight_tok = None
                    if ticket is not None:
                        self.wlm.release(ticket)
            finally:
                self.inflight.done(tok)
        finally:
            try:
                if pin_tok is not None:
                    tier.release_pins(pin_tok)
                    self.last_stats["tier"] = tier.stats_snapshot()
                    enc_info = getattr(tier_ds, "encoding_info", None)
                    if enc_info is not None:
                        self.last_stats["encoding"] = enc_info()
            finally:
                if qid is not None:
                    self.release_query(qid)
            # after the releases: a failing stats snapshot must not be
            # able to strand the pin or the cancel flag
            if self.fault is not None:
                self.last_stats["fault"] = self.fault.stats()

    def _execute_admitted(self, q: S.QuerySpec, t0: float) -> QueryResult:
        """Result-cache lookup, the device-loss gate, then the coalescer
        or ``_execute_inner``, then ``cache.put``. An exception is never
        cached; one the classifier calls a device loss
        (:func:`_is_backend_loss`) marks the device lost and demotes the
        statement to the host tier."""
        try:
            pinfo = self.store.recovery_info.get(
                getattr(q, "datasource", None))
            if pinfo is not None:
                # the datasource was rebuilt from deep storage this
                # session — surface where it came from (snapshot / wal /
                # both) and what checksum verification cost
                self.last_stats["persist"] = dict(pinfo)
            cache = self.result_cache
            use_cache = cache.enabled and cache.cacheable(q)
            if use_cache:
                # the lookup precedes the device-loss gate on purpose: a
                # cached answer needs no device, so hits keep serving
                # while the host tier covers the misses
                ds_version = self.store.datasource_version(q.datasource)
                served, status = cache.lookup(q, ds_version)
                if served is not None:
                    self.last_stats["cache"] = status
                    self.last_stats["datasource"] = q.datasource
                    self.last_stats["total_ms"] = \
                        (_time.perf_counter() - t0) * 1000
                    return served
            if self.cluster is not None and self.cluster.should_distribute(q):
                # broker path: scatter per-shard subqueries to the
                # historicals and merge partials. Sits UNDER the cache
                # (hits never leave this process) and ABOVE the
                # device-loss gate (the scatter needs no local device).
                # None = the client declined mid-flight (serde gap, node
                # EngineFallback, replicas exhausted with local fallback
                # enabled) — fall through to ordinary local execution.
                r = self.cluster.execute(q, t0)
                if r is not None:
                    # degraded (partial-results) answers must NEVER enter
                    # the result cache: a later healthy run would serve
                    # the hole forever
                    if use_cache and r.degraded is None:
                        cache.put(q, ds_version, r)
                        self.last_stats["cache"] = "miss"
                    return r
            if self._backend_lost_at is not None \
                    and not self._try_reattach():
                self.last_stats["backend_lost"] = {
                    "site": self._backend_lost_site}
                raise EngineFallback(
                    "backend_lost (device unreachable; host tier serving)")
            if self.sharedscan.should_try(q):
                # coalesce with concurrent eligible queries on the same
                # datasource (parallel/sharedscan.py); under the cache, so
                # each constituent populates its own key
                r = self.sharedscan.run(q, t0)
            else:
                r = self._execute_inner(q, t0)
            if use_cache:
                cache.put(q, ds_version, r)
                self.last_stats["cache"] = "miss"
            return r
        except EC.Unsupported as e:
            # an expression or filter the device path cannot compile:
            # the signal a planner answers with a host residual
            raise EngineFallback(str(e)) from e
        except Exception as e:  # noqa: BLE001 — classify device loss
            # the classifier reads the error's text; the probe observes
            # whether the context still answers: a device that does was
            # not lost, and the error raises as itself
            if _is_backend_loss(e) and not _probe_device_alive(self.device):
                site = _loss_site(e)
                self._mark_backend_lost(site)
                raise EngineFallback(
                    f"backend_lost (at {site}; {type(e).__name__}: "
                    f"{str(e)[:120]})") from e
            raise

    def _mark_backend_lost(self, site: str = "?"):
        """Drop everything that references device memory (programs, the
        bind cache); the host tier serves until a re-attach probe
        succeeds. ``site`` (:func:`_loss_site`) goes into
        ``last_stats["backend_lost"]``, so a fault of the port's own
        kernels can be told apart from a loss elsewhere."""
        with self._compile_lock:
            self._backend_lost_at = _time.time()
            self._backend_retry_at = self._backend_lost_at \
                + float(self.config.get(BACKEND_RETRY_SECONDS))
            self._backend_lost_site = site
            self._programs.clear()
        with self._bind_lock:
            self._device_arrays.clear()
            self._device_bytes = 0
        self.last_stats["backend_lost"] = {"site": site}

    def _try_reattach(self) -> bool:
        """At most one bounded device probe per cooldown window. The
        probe runs in a daemon thread with a hard deadline, so a hung
        dispatch cannot take the session down with it.

        On a card the probe is a trivial dispatch and a synchronize. A
        sticky CUDA error poisons the process's context for good, so after
        one no probe in this process succeeds: the device comes back with
        a new process, which recovers a persisted store with nothing
        acknowledged lost (``persist/``). A probe can succeed only after a
        loss that left the context usable."""
        now = _time.time()
        with self._compile_lock:
            if now < self._backend_retry_at:
                return False
            # claim this window under the lock so concurrent statements
            # don't pile probes onto a dead device
            self._backend_retry_at = now \
                + float(self.config.get(BACKEND_RETRY_SECONDS))
        if _probe_device_alive(self.device):
            with self._compile_lock:
                self._backend_lost_at = None
            return True
        return False

    def reshard(self, devices=None) -> None:
        """Rebuild the engine over the live device set (the JAX engine's
        ``reshard``, which a re-attach runs when the mesh's size
        changed)."""
        raise not_ported("resharding onto the live devices", "A.8")

    def _execute_inner(self, q: S.QuerySpec, t0: float) -> QueryResult:
        self._stage_check(q, t0)
        if isinstance(q, S.GroupByQuerySpec):
            r = self._run_agg(q, list(q.dimensions), q.aggregations,
                              q.post_aggregations, q.having, q.limit,
                              q.granularity, q.filter, q.intervals, t0)
        elif isinstance(q, S.TimeseriesQuerySpec):
            r = self._run_agg(q, [], q.aggregations, q.post_aggregations,
                              None, None, q.granularity, q.filter,
                              q.intervals, t0)
        elif isinstance(q, S.TopNQuerySpec):
            r = self._run_agg(q, [q.dimension], q.aggregations,
                              q.post_aggregations, None, S.topn_limit(q),
                              q.granularity, q.filter, q.intervals, t0)
        elif isinstance(q, S.SelectQuerySpec):
            r = self._run_select(q)
        elif isinstance(q, S.SearchQuerySpec):
            r = self._run_search(q)
        else:
            raise EngineFallback(f"query type {type(q).__name__}")
        self.last_stats["total_ms"] = (_time.perf_counter() - t0) * 1000
        return r

    # -- aggregation path -----------------------------------------------------
    def _run_agg(self, q, dimensions: List[S.DimensionSpec], aggregations,
                 post_aggregations, having, limit, granularity, filter_spec,
                 intervals, t0: Optional[float] = None,
                 no_topk: bool = False) -> QueryResult:
        ds = self.store.get(q.datasource)

        def check():
            # a stage boundary: cancel and deadline take effect here
            if t0 is not None:
                self._stage_check(q, t0)

        seg_idx = ds.prune_segments(intervals, filter_spec)
        gran_kind = granularity.kind if granularity else "all"

        if ds.num_rows == 0 or len(seg_idx) == 0:
            names = (["timestamp"] if gran_kind != "all" else [])
            names += [d.output_name for d in dimensions]
            names += [a.name for a in aggregations]
            names += [p.name for p in post_aggregations]
            if not dimensions and gran_kind == "all":
                # a global aggregate over an empty/pruned scan still yields
                # the one identity row
                data = _identity_row(
                    {a.name: _AGG_KIND.get(a.kind, ("sum", None))[0]
                     for a in aggregations})
                for p in post_aggregations:
                    v = np.asarray(host_eval.eval_expr(p.expr, data))
                    data[p.name] = np.broadcast_to(v, (1,)) if v.ndim == 0 \
                        else v
                if having is not None:
                    keep = host_eval.eval_pred3(having.expr, data)
                    data = {k: v[keep] for k, v in data.items()}
                self.last_stats.update({
                    "datasource": ds.name, "segments": 0,
                    "groups": int(len(next(iter(data.values()))))
                    if data else 0, "rows_scanned": 0})
                return QueryResult(names, data)
            return QueryResult.empty(names)

        all_dim_plans, agg_plans, min_day, max_day, n_keys, names, routes = \
            self._plan_agg(ds, seg_idx, dimensions, aggregations,
                           granularity, filter_spec, intervals)
        cards = [p.card for p in all_dim_plans]
        route_hashed, spw, n_waves = self._scan_wave_plan(
            ds, seg_idx, all_dim_plans, agg_plans, n_keys, names)
        if route_hashed:
            return self._run_agg_hashed(
                q, ds, seg_idx, all_dim_plans, agg_plans, names, min_day,
                max_day, post_aggregations, having, limit, filter_spec,
                intervals, check, spw, n_waves, no_topk=no_topk)
        topk = None if no_topk or n_waves > 1 else \
            self._plan_device_topk(limit, having, agg_plans, n_keys)
        having_dev = self._plan_device_having(having, routes, n_keys,
                                              n_waves)
        n_out = topk[1] if topk else n_keys
        sketch_plans = [p for p in agg_plans if p.kind in SKETCH_KINDS]
        shape = (ds.name, ds.serial, _cache_repr(q), len(seg_idx),
                 ds.padded_rows, min_day, max_day, tuple(names),
                 self.config.get(TZ_ID))
        host = {}
        t = _time.perf_counter()
        if having_dev:
            # two dispatches: the finals stay on the device; the passing
            # count travels, then only the passing groups
            dev_arrays = self._bind_arrays(ds, names, seg_idx)
            t = _phase("bind", t)
            check()
            table = self._make_core(ds, all_dim_plans, agg_plans,
                                    filter_spec, intervals, min_day,
                                    max_day, n_keys, routes)(dev_arrays)
            mask = _having_mask(having_dev, table, routes)
            cnt = int(_to_host({"__stats__": mask.sum().reshape(1)})
                      ["__stats__"][0])
            check()
            n_out = min(n_keys, 1 << max(6, (max(cnt, 1) - 1).bit_length()))
            # most groups pass: the whole table travels in key order with
            # the failing groups' occupancy zeroed (no selection pass)
            full = n_out * 2 >= n_keys
            if full:
                n_out = n_keys
            host = _to_host(_having_gather(table, mask, n_out, n_keys,
                                           full))
            finals = _finals_from_out(host, routes, n_out, sketch_plans)
        elif n_waves == 1:
            # budget from the cheap conjuncts only: the staged ones apply
            # after compaction and do not shrink what the prefix must hold
            cheap_f0, _ = self._split_filter_staged(filter_spec)
            compact_m = self._plan_compact_m(ds, seg_idx, cheap_f0,
                                             routes=routes, n_keys=n_keys)
            memo = ("agg", shape, topk)
            if compact_m and memo in self._compact_overflowed:
                compact_m = None     # this shape overflowed before
            dev_arrays = self._bind_arrays(ds, names, seg_idx)
            t = _phase("bind", t)
            for cm in ((compact_m, None) if compact_m else (None,)):
                check()      # pre-dispatch boundary
                out = self._make_core(ds, all_dim_plans, agg_plans,
                                      filter_spec, intervals, min_day,
                                      max_day, n_keys, routes,
                                      compact_m=cm)(dev_arrays)
                over = out.pop("__over__", None)
                if topk:
                    out = _topk_gather(out, routes, topk, n_keys)
                if over is not None:
                    out["__over__"] = over
                host = _to_host(out)
                check()      # post-device boundary
                over = host.pop("__over__", None)
                if over is None or int(over[0]) == 0:
                    if cm:
                        self.last_stats["compact_m"] = int(cm)
                    break
                # the selectivity estimate was too optimistic: retry
                # uncompacted, and let warm runs of this shape skip it
                self.last_stats["compact_overflow"] = int(over[0])
                self._compact_overflowed.add(memo)
            finals = _finals_from_out(host, routes, n_out, sketch_plans)
        else:
            # wave-mode late materialization: the compaction runs inside
            # each wave with a per-wave budget (the first wave's rows stand
            # for all: waves are equal splits); a wave that overflows its
            # budget ends the run, and the whole scan re-runs uncompacted
            cheap_f0, _ = self._split_filter_staged(filter_spec)
            compact_m = self._plan_compact_m(ds, seg_idx[:spw], cheap_f0,
                                             routes=routes, n_keys=n_keys)
            memo = ("aggw", shape, spw)
            if compact_m and memo in self._compact_overflowed:
                compact_m = None
            for cm in ((compact_m, None) if compact_m else (None,)):
                core = self._make_core(ds, all_dim_plans, agg_plans,
                                       filter_spec, intervals, min_day,
                                       max_day, n_keys, routes,
                                       compact_m=cm)
                finals, wave_over = self._run_waves(
                    ds, names, seg_idx, spw, core, routes, n_keys,
                    sketch_plans, check)
                if not wave_over:
                    if cm:
                        self.last_stats["compact_m"] = int(cm)
                    break
                self.last_stats["compact_overflow"] = int(wave_over)
                self._compact_overflowed.add(memo)
            # the waves charged their own bind and dispatch phases
            t = _time.perf_counter()
        t = _phase("dispatch", t)
        # the key ids of a selection (device top-k, device HAVING); rows
        # of the whole table come in key order
        top_idx = host["__topk_idx__"].astype(np.int64) \
            if "__topk_idx__" in host else None

        # --- decode -----------------------------------------------------------
        rows = finals["__rows__"]
        sel = np.nonzero(rows > 0)[0]
        # a GLOBAL aggregate (no dims, no time bucketing) over zero matching
        # rows yields ONE identity row
        global_empty = (not all_dim_plans and gran_kind == "all"
                        and len(sel) == 0)
        if global_empty:
            sel = np.zeros(1, dtype=np.int64)
        data: Dict[str, np.ndarray] = {}
        columns: List[str] = []
        if all_dim_plans:
            key_ids = top_idx[sel] if top_idx is not None else sel
            code_lists = G.unfuse_key(key_ids, cards)
            for p, codes in zip(all_dim_plans, code_lists):
                data[p.output_name] = p.decode(codes)
                columns.append(p.output_name)
        for p in agg_plans:
            name = p.spec.name
            data[name] = _decode_agg_value(ds, p, routes.get(name),
                                           finals[name][sel],
                                           self.partial_sketches)
            columns.append(name)
        if global_empty:
            data.update(_identity_row(
                {p.spec.name: p.kind for p in agg_plans
                 if p.kind in ("sum", "min", "max")}))

        data = self._agg_epilogue(data, columns, post_aggregations, having,
                                  limit)
        _phase("epilogue", t)
        if topk and not isinstance(q, S.TopNQuerySpec):
            # exact-contract GroupBy: prove the boundary row clears the
            # cutoff of the device selection, or re-run without it
            if not _topk_selection_exact(limit, topk, routes[topk[0]],
                                         host["__topk_score__"], data):
                return self._run_agg(q, dimensions, aggregations,
                                     post_aggregations, having, limit,
                                     granularity, filter_spec, intervals,
                                     t0, no_topk=True)
        self.last_stats.update({
            "datasource": ds.name, "segments": int(len(seg_idx)),
            "groups": int(len(sel)), "rows_scanned": int(ds.num_rows),
            "waves": int(n_waves), "segments_per_wave": int(spw),
            "route": "kernel" if G.use_kernel(
                n_keys, list(routes.values()),
                self.config.get(GROUPBY_PALLAS_MAX_KEYS)) else "scatter",
            "topk_device": int(topk[1]) if topk else 0,
            "having_device": int(n_out) if having_dev else 0})
        return QueryResult(columns, data)

    def _plan_device_having(self, having, routes, n_keys, n_waves):
        """``(aggregate, op, integer literal)`` when HAVING is one
        comparison of an exact aggregate (an ``i64`` or ``f64`` route)
        with an integer literal, the scan runs in one wave and the key
        space is at least ``sdot.engine.having.device.min.keys``, else
        None. The host epilogue re-applies HAVING over the exact finals,
        so the device mask only filters what travels."""
        if having is None or n_waves != 1 \
                or n_keys < self.config.get(HAVING_DEVICE_MIN_KEYS):
            return None
        e = having.expr
        if not isinstance(e, E.Comparison):
            return None
        for a, b, op in ((e.left, e.right, e.op),
                         (e.right, e.left, E.FLIP_CMP.get(e.op, e.op))):
            if isinstance(a, E.Column) and isinstance(b, E.Literal) \
                    and isinstance(b.value, (int, np.integer)) \
                    and not isinstance(b.value, bool):
                r = routes.get(a.name)
                if r is None:
                    continue
                lit = int(b.value)
                # the literal must fit the route's comparable domain
                if r.tag == "i64" and not -2**62 <= lit < 2**62:
                    continue
                if r.tag in ("i64", "f64"):
                    return (a.name, "!=" if op == "<>" else op, lit)
        return None

    @staticmethod
    def _split_filter_staged(f):
        """(cheap, expensive) for staged filter evaluation under
        compaction: top-level AND conjuncts whose lowering must gather
        (a large integer membership set that does not lower to a compare
        chain, keyed-lookup expressions: the decorrelated-EXISTS
        machinery) evaluate after compaction, on the survivors of the
        cheap conjuncts only."""
        def expr_has_gather(e):
            found = [False]

            def visit(n):
                if isinstance(n, (E.KeyedLookup, E.KeyedLookup2)):
                    found[0] = True
                if isinstance(n, E.InList) \
                        and isinstance(n.values, E.FrozenIntSet) \
                        and not EC.int_set_lowers_to_chain(n.values.array):
                    found[0] = True
                return n
            E.transform(e, visit)
            return found[0]

        def is_expensive(x):
            if isinstance(x, S.InFilter) \
                    and isinstance(x.values, E.FrozenIntSet) \
                    and not EC.int_set_lowers_to_chain(x.values.array):
                return True
            if isinstance(x, S.ExprFilter):
                return expr_has_gather(x.expr)
            if isinstance(x, S.LogicalFilter) and x.op == "not":
                return is_expensive(x.fields[0])
            return False

        if f is None:
            return None, None
        conj = list(f.fields) if isinstance(f, S.LogicalFilter) \
            and f.op == "and" else [f]
        cheap = [x for x in conj if not is_expensive(x)]
        exp = [x for x in conj if is_expensive(x)]
        if not exp:
            return f, None

        def rejoin(parts):
            if not parts:
                return None
            if len(parts) == 1:
                return parts[0]
            return S.LogicalFilter("and", tuple(parts))

        return rejoin(cheap), rejoin(exp)

    def _plan_compact_m(self, ds, seg_idx, filter_spec, routes=None,
                        n_keys=None, n_ops=None):
        """Static survivor budget for late materialization (None = do
        not compact): the filter-selectivity estimate
        (``cost._filter_selectivity``) with a 2x margin, rounded up to a
        power of two; a wrong estimate shows as the core's ``__over__``
        and retries uncompacted. ``min.rows`` 0 skips the cost test (the
        test and config override). Otherwise the compaction costs
        ``rows * sort + M * n_ops * gather`` and must cost less than what
        the removed rows would cost downstream
        (:meth:`_compaction_saving`)."""
        if filter_spec is None or not self.config.get(SCAN_COMPACT):
            return None
        min_rows = int(self.config.get(SCAN_COMPACT_MIN_ROWS))
        rows = _rows_of(ds, seg_idx)
        if min_rows > 0 and rows < min_rows:
            return None                  # small scans: the pass wins nothing
        sel = C._filter_selectivity(filter_spec, ds)
        est = rows * sel * 2.0           # safety margin before retry
        m = 1 << max(6, int(np.ceil(np.log2(max(est, 1.0)))))
        m = max(m, 1 << 15) if rows >= (1 << 21) else m
        if m > rows // 2:
            return None                  # unselective: nothing to remove
        if min_rows > 0:
            if n_ops is None:
                n_ops = max(1, len(routes)) if routes is not None else 4
            n_ops = min(int(n_ops), 8)
            sort_s = rows * unit_cost(self.config, COST_SORT_ROW,
                                      self.device)
            gather_s = m * n_ops * unit_cost(self.config, COST_GATHER_PROBE,
                                             self.device)
            if sort_s + gather_s >= self._compaction_saving(
                    rows, rows - m, routes, n_keys, n_ops):
                return None
        return int(m)

    def _compaction_saving(self, rows, removed, routes, n_keys, n_ops):
        """Seconds the ``removed`` rows would cost the aggregation tier.
        A cpu device prices them as the JAX package does on its x64
        routes: ``n_ops`` scatter updates each, at the big-table cost
        when the group table passes ``table.cache.bytes``. A cuda device
        prices a statement the fused kernel (B1) takes at B1's measured
        cost per row, and the scatter tier at the measured curve's value
        for the statement's rows per group; the curve spans tables up to
        ``cost.PROBE_SCATTER_SLOTS[-1]`` slots, the big-table cost holds
        past them."""
        slots = int(n_keys) if n_keys else 1 << 16
        if self.device.type == "cpu":
            big = slots * 4 * (len(routes) if routes else n_ops) \
                > int(self.config.get(COST_TABLE_CACHE_BYTES))
        else:
            if routes is not None and G.use_kernel(
                    slots, list(routes.values()),
                    self.config.get(GROUPBY_PALLAS_MAX_KEYS)):
                return removed * unit_cost(self.config, COST_FUSED_ROW,
                                           self.device)
            big = slots > C.PROBE_SCATTER_SLOTS[-1]
        sc = unit_cost(self.config, COST_SCATTER_UPDATE_BIG, self.device) \
            if big else unit_cost(self.config, COST_SCATTER_UPDATE,
                                  self.device,
                                  rows_per_slot=rows / max(1, min(slots,
                                                                  rows)))
        return removed * sc * n_ops

    def _plan_device_topk(self, limit, having, agg_plans, n_keys):
        """Whether the ordered limit selects its candidates on the device:
        ``(metric, k_sel, ascending)`` or None. The selection scores each
        key by its metric (``ops.groupby.route_score``) and only the best
        ``k_sel`` rows travel; the host orders them exactly. Skipped under
        HAVING, for a metric decoded from dictionary codes, and when
        ``k_sel`` is a quarter of the key space or more."""
        if having is not None or limit is None or limit.limit is None:
            return None
        if not limit.columns:
            return None
        if n_keys < self.config.get(TOPN_DEVICE_MIN_KEYS):
            return None
        oc = limit.columns[0]
        mplan = next((p for p in agg_plans if p.spec.name == oc.name), None)
        if mplan is None or mplan.kind in SKETCH_KINDS or mplan.dim_codes:
            return None          # a sketch's registers are no score
        k_sel = min(n_keys, _topk_slack(limit))
        if k_sel * 4 >= n_keys:
            return None              # full transfer is already cheap
        return (oc.name, k_sel, bool(oc.ascending))

    def _sorted_run_wanted(self, rows: int, key_space: int) -> bool:
        """The one gate of the sorted-run tier and of the medium-K reroute
        onto it: 'on' / 'off' win; 'auto' engages when riding one payload
        through the slot sort costs less per row than one scatter update
        on this engine's device (``parallel/cost.unit_cost``), the scatter
        read at ``rows`` (the segment-pruned rows) over the groups they
        can form, ``min(key_space, rows)``."""
        mode = str(self.config.get(GROUPBY_HASH_SORTED))
        if mode in ("on", "off"):
            return mode == "on"
        per_slot = rows / max(1, min(int(key_space), int(rows)))
        return unit_cost(self.config, COST_SORT_PAYLOAD_ROW, self.device) \
            < unit_cost(self.config, COST_SCATTER_UPDATE, self.device,
                        rows_per_slot=per_slot)

    def wave_plan(self, q: S.QuerySpec):
        """``(segments per wave, waves)`` of the scan that executing the
        aggregation spec ``q`` runs, on its dense or its hashed route: the
        plan ``_run_agg`` itself takes (``_scan_wave_plan``). ``(0, 1)``
        where interval pruning leaves nothing to scan."""
        if not isinstance(q, (S.GroupByQuerySpec, S.TimeseriesQuerySpec,
                              S.TopNQuerySpec)):
            raise TypeError(f"no aggregation scan in {type(q).__name__}")
        dims = list(q.dimensions) if isinstance(q, S.GroupByQuerySpec) \
            else [q.dimension] if isinstance(q, S.TopNQuerySpec) else []
        ds = self.store.get(q.datasource)
        seg_idx = ds.prune_segments(q.intervals, q.filter)
        if ds.num_rows == 0 or len(seg_idx) == 0:
            return 0, 1
        dim_plans, agg_plans, _, _, n_keys, names, _ = self._plan_agg(
            ds, seg_idx, dims, q.aggregations, q.granularity, q.filter,
            q.intervals)
        return self._scan_wave_plan(ds, seg_idx, dim_plans, agg_plans,
                                    n_keys, names)[1:]

    def _scan_wave_plan(self, ds, seg_idx, dim_plans, agg_plans, n_keys,
                        names):
        """``(hashed, segments per wave, waves)`` of an aggregation scan:
        the hashed route above the dense key-space ceiling and for the
        medium-K reroute, else the dense one; the wave plan prices the
        dense route's key space, the hashed route's first table."""
        hashed = n_keys > self.config.get(GROUPBY_DENSE_MAX_KEYS)
        if not hashed:
            # medium-K reroute: the same gate as the sorted-run tier, so
            # its 'off' switch also keeps medium-K queries dense; sketch
            # registers stay on the dense route
            min_k = int(self.config.get(GROUPBY_SORTED_MIN_KEYS))
            if min_k > 0 and n_keys >= min_k \
                    and not any(p.kind in SKETCH_KINDS for p in agg_plans) \
                    and self._sorted_run_wanted(_rows_of(ds, seg_idx),
                                                n_keys):
                hashed = True
        groups = n_keys
        if hashed:
            rows_sel = _rows_of(ds, seg_idx)
            groups = min(rows_sel, self._hash_slots(
                rows_sel, _key_space(dim_plans)))
        spw, n_waves = self._plan_waves(ds, names, seg_idx, groups,
                                        len(agg_plans))
        return hashed, spw, n_waves

    def _hash_max_slots(self) -> int:
        """The largest table the hashed route grows to on this device."""
        max_slots = int(self.config.get(GROUPBY_HASH_MAX_SLOTS))
        if self.device.type == "cpu":
            max_slots = min(max_slots, int(self.config.get(
                GROUPBY_HASH_MAX_SLOTS_CPU)))
        return max_slots

    def _hash_slots(self, rows_sel: int, n_keys_total: int) -> int:
        """The hashed route's first table size ``T``: the configured one,
        else sized from the key space and the selected rows (which bound
        the group count)."""
        return int(self.config.get(GROUPBY_HASH_SLOTS)) or H.initial_slots(
            min(n_keys_total, rows_sel), hi=self._hash_max_slots())

    # -- hashed high-cardinality aggregation path -----------------------------
    def _run_agg_hashed(self, q, ds, seg_idx, dim_plans, agg_plans, names,
                        min_day, max_day, post_aggregations, having, limit,
                        filter_spec, intervals, check, spw, n_waves,
                        no_topk: bool = False):
        """Group-by above the dense key-space ceiling (and the medium-K
        reroute): a table of ``T`` slots on the device per wave
        (``ops/hash_groupby.py``), the waves' partials merged by key on
        the host, in the waves ``_scan_wave_plan`` planned. Overflow in
        any wave retries the scan at 4x slots, then falls back. ``check``
        is the statement's stage boundary (before each dispatch and wave,
        and after the last)."""
        if any(p.kind in SKETCH_KINDS for p in agg_plans):
            raise EngineFallback("sketch aggregation over hashed group-by")
        cards = [p.card for p in dim_plans]
        try:
            parts = H.split_parts(cards)
        except H.KeySpaceTooWide as e:
            raise EngineFallback(str(e)) from e
        rows_sel = _rows_of(ds, seg_idx)
        n_keys_total = _key_space(dim_plans)
        max_slots = self._hash_max_slots()
        T = self._hash_slots(rows_sel, n_keys_total)
        wave_segs = FU.plan_device_waves(seg_idx, spw, 1)
        metas = [G.AggInput(p.spec.name, p.kind, is_int=p.is_int)
                 for p in agg_plans]
        topk_plan = None if no_topk else \
            self._plan_device_topk_hashed(limit, having, agg_plans, n_waves)
        kg_used = 0
        tk_scores = None
        # late materialization (shared with the dense path), in one wave
        # only: the key build and the aggregation shrink to the survivors;
        # a budget overflow folds into '__unres__' and the first retry
        # turns it off at the same T
        cheap_f0, _ = self._split_filter_staged(filter_spec)
        lm = self._plan_compact_m(ds, seg_idx, cheap_f0, n_keys=T,
                                  n_ops=len(agg_plans) + 2) \
            if n_waves == 1 else None
        memo = ("hashlm", ds.name, _cache_repr(q))
        if lm and memo in self._compact_overflowed:
            lm = None
        while True:
            # k_sel * 4 <= T also bounds k_sel < T
            topk = topk_plan if topk_plan and topk_plan[1] * 4 <= T \
                else None
            compact = topk is None \
                and T >= self.config.get(GROUPBY_HASH_COMPACT_MIN)
            sorted_run = self._sorted_run_wanted(rows_sel, n_keys_total)
            routes = SG.plan_sorted_routes(metas) if sorted_run \
                else G.plan_routes(metas)
            core = self._hash_core(ds, dim_plans, parts, agg_plans,
                                   filter_spec, intervals, min_day, max_day,
                                   T, routes, sorted_run, compact_m=lm)
            t = _time.perf_counter()
            if n_waves == 1:
                arrays = self._bind_arrays(ds, names, seg_idx)
                t = _phase("bind", t)
                check()
                outs = [core(arrays)]
            else:
                binder = _WaveBinder(ds, names, spw, self.device)
                outs = binder.stream(core, wave_segs, check)
            partials, unresolved = [], 0
            # each wave's outputs; under waves the next wave's bind is
            # already issued when the host syncs on this one's
            for out in outs:
                if compact:
                    # dispatch 1 of 2: the table stays on the device; only
                    # [unresolved, occupied] travel
                    occ = (out["__tkhi__"] != H.EMPTY).sum()
                    unres, occupied = (int(x) for x in torch.stack(
                        [out.pop("__unres__")[0], occ]).cpu())
                    unresolved += unres
                    if unresolved:
                        break
                    # dispatch 2 of 2: the occupied slots are the table's
                    # prefix [0, G); copy a power of two of them
                    kg = min(T, 1 << max(6, (max(1, occupied) - 1)
                                         .bit_length()))
                    kg_used = max(kg_used, kg)
                    raw = _to_host({k: v[:kg] for k, v in out.items()})
                    k_out = kg
                else:
                    if topk:
                        unres = out.pop("__unres__")
                        out = _hash_topk_gather(out, routes, topk, T)
                        out["__unres__"] = unres
                    raw = _to_host(out)
                    unresolved += int(raw.pop("__unres__")[0])
                    if unresolved:
                        break
                    k_out = topk[1] if topk else T
                    if topk:
                        tk_scores = raw.pop("__topk_score__")
                partials += _hash_partial(raw, routes, k_out)
            if n_waves > 1:
                # the waves charged their own bind and dispatch phases
                self.last_stats["wave_steps"] = binder.steps()
                t = _time.perf_counter()
            t = _phase("dispatch", t)
            if not unresolved:
                if lm:
                    self.last_stats["compact_m"] = int(lm)
                break
            if lm:
                # the compaction budget may be what overflowed: drop it at
                # the same T first; only a second failure grows the table
                self.last_stats["compact_overflow"] = int(unresolved)
                self._compact_overflowed.add(memo)
                lm = None
                continue
            T *= 4
            if T > max_slots:
                raise EngineFallback(
                    f"hashed group-by exceeded {max_slots} table slots")
        check()
        keys, merged = _merge_hash_partials(partials, routes)
        data: Dict[str, np.ndarray] = {}
        columns: List[str] = []
        khi, klo = H.unpack_key(keys)
        part_vals = [khi, klo]
        dim_codes: Dict[int, np.ndarray] = {}
        for pi, idxs in enumerate(parts):
            for i, c in zip(idxs, H.unfuse_part(part_vals[pi], cards, idxs)):
                dim_codes[i] = c
        for i, p in enumerate(dim_plans):
            data[p.output_name] = p.decode(dim_codes[i])
            columns.append(p.output_name)
        for p in agg_plans:
            name = p.spec.name
            data[name] = _decode_agg_value(ds, p, routes[name], merged[name])
            columns.append(name)
        data = self._agg_epilogue(data, columns, post_aggregations, having,
                                  limit)
        _phase("epilogue", t)
        if topk and not isinstance(q, S.TopNQuerySpec):
            # the dense epilogue's proof, over the table's slot scores
            scores = np.sort(np.asarray(tk_scores, np.float64))[::-1]
            if not _topk_selection_exact(limit, topk, routes[topk[0]],
                                         scores, data):
                return self._run_agg_hashed(
                    q, ds, seg_idx, dim_plans, agg_plans, names, min_day,
                    max_day, post_aggregations, having, limit, filter_spec,
                    intervals, check, spw, n_waves, no_topk=True)
        self.last_stats.update({
            "datasource": ds.name, "segments": int(len(seg_idx)),
            "groups": int(len(keys)), "rows_scanned": int(ds.num_rows),
            "waves": len(wave_segs), "segments_per_wave": int(spw),
            "route": "sorted" if sorted_run else "scatter", "hashed": True,
            "hash_slots": int(T), "hash_compact_k": int(kg_used),
            "topk_device": int(topk[1]) if topk else 0})
        return QueryResult(columns, data)

    def _plan_device_topk_hashed(self, limit, having, agg_plans, n_waves):
        """Device top-k over the hash table: only the best ``k_sel`` slots
        travel. One wave only: the table is then complete and the slot
        scores are global. Under waves a key's partials are split across
        the waves' tables, so a per-wave selection could miss a key large
        in total; the full tables merge by key instead."""
        if having is not None or limit is None or limit.limit is None \
                or n_waves != 1:
            return None
        if not limit.columns:
            return None
        oc = limit.columns[0]
        mplan = next((p for p in agg_plans if p.spec.name == oc.name), None)
        if mplan is None or mplan.dim_codes:
            return None
        return (oc.name, _topk_slack(limit), bool(oc.ascending))

    def _hash_core(self, ds, dim_plans, parts, agg_plans, filter_spec,
                   intervals, min_day, max_day, T, routes, sorted_run,
                   compact_m=None):
        """The hash scan body: scan -> filter -> per-dim codes -> two-part
        key -> slot sort -> the sorted-run or the scatter aggregation into
        [T] tables. Returns the route outputs, the '__tkhi__' /
        '__tklo__' key tables and '__unres__' ([1]). With ``compact_m``
        the key build and the aggregation run on the compacted prefix,
        and a budget overflow adds to '__unres__'."""
        cards = [p.card for p in dim_plans]
        tz = self.config.get(TZ_ID)
        cheap_f, exp_f = (self._split_filter_staged(filter_spec)
                          if compact_m else (filter_spec, None))
        fuse_cse = bool(self.config.get(SHAREDSCAN_FUSION_ENABLED))

        def core(arrays):
            ctx = ScanContext(ds, arrays, min_day, max_day, tz=tz)
            cse, base = _scan_base(ctx, cheap_f, intervals, fuse_cse)
            n_over = None
            if compact_m:
                ctx, cse, base, n_over = _compact(
                    ctx, base, compact_m, exp_f, fuse_cse)
            codes = [p.build(ctx) for p in dim_plans]
            khi = H.fuse_part(codes, cards, parts[0])
            klo = H.fuse_part(codes, cards, parts[1]) if len(parts) > 1 \
                else torch.zeros_like(khi)
            cols = [khi, klo]
            for p in agg_plans:
                cols += [p.build_values(ctx), p.build_mask(ctx, cse=cse)]
            valid, cols = H.live_rows(base, cols)
            khi, klo = cols[:2]
            inputs = [G.AggInput(p.spec.name, p.kind, cols[2 + 2 * i],
                                 cols[3 + 2 * i], is_int=p.is_int)
                      for i, p in enumerate(agg_plans)]
            if sorted_run:
                out = SG.sorted_hash_groupby(khi, klo, valid, T, inputs,
                                             routes)
            else:
                slot, tk_hi, tk_lo, unresolved = H.build_slots(
                    khi, klo, valid, T)
                # pallas_max 0: the hashed tier always scatters, as in JAX
                out = G.dense_groupby(slot, valid, T, inputs, routes, 0)
                out["__tkhi__"] = tk_hi
                out["__tklo__"] = tk_lo
                out["__unres__"] = unresolved.reshape(1)
            if n_over is not None:
                u = out["__unres__"]
                out["__unres__"] = u + n_over.to(u.dtype)
            return out

        return core

    def _agg_epilogue(self, data, columns, post_aggregations, having, limit):
        """Host epilogue: post aggregations, HAVING, ORDER BY + LIMIT."""
        for pa in post_aggregations:
            data[pa.name] = np.asarray(host_eval.eval_expr(pa.expr, data))
            columns.append(pa.name)
        if having is not None:
            keep = host_eval.eval_pred3(having.expr, data)
            data = {k: v[keep] for k, v in data.items()}
        if limit is not None and limit.columns:
            order_keys = []
            for oc in reversed(limit.columns):
                k = data[oc.name]
                if k.dtype == object and all(
                        v is None or isinstance(v, (int, np.integer))
                        for v in k):
                    # wide-int min/max columns with empty groups: exact
                    # int64 sort, nulls last via a more-significant flag
                    nulls = np.array([v is None for v in k])
                    vals = np.array([0 if v is None else int(v) for v in k],
                                    dtype=np.int64)
                    order_keys.append(vals if oc.ascending else -vals)
                    order_keys.append(nulls)
                    continue
                if k.dtype == object:
                    k = k.astype(str)
                order_keys.append(k if oc.ascending else _neg_key(k))
            idx = np.lexsort(order_keys)
            if limit.limit is not None:
                idx = idx[: limit.limit]
            data = {k: v[idx] for k, v in data.items()}
        elif limit is not None and limit.limit is not None:
            data = {k: v[: limit.limit] for k, v in data.items()}
        return data

    def _plan_agg(self, ds, seg_idx, dimensions, aggregations, granularity,
                  filter_spec, intervals):
        """Planning for agg queries. Returns (dim_plans incl. granularity,
        agg_plans, min_day, max_day, n_keys, array names, routes)."""
        gran_kind = granularity.kind if granularity else "all"
        mins, maxs = ds.segment_time_bounds()
        min_day = int(mins[seg_idx].min() // T.MILLIS_PER_DAY)
        max_day = int(maxs[seg_idx].max() // T.MILLIS_PER_DAY)
        tz = self.config.get(TZ_ID)
        dim_plans = [plan_dimension(d, ds, min_day, max_day, tz)
                     for d in dimensions]
        if gran_kind != "all":
            dim_plans = [plan_granularity_dim(granularity, ds, min_day,
                                              max_day, tz)] + dim_plans
        agg_plans = [plan_aggregation(a, ds) for a in aggregations]
        n_keys = 1
        for p in dim_plans:
            n_keys *= p.card
        needed = set()
        for p in dim_plans:
            needed |= set(p.source_cols)
        for p in agg_plans:
            needed |= set(p.source_cols)
        needed |= F.columns_of_filter(filter_spec)
        time_in_play = ds.time is not None and (
            intervals is not None or gran_kind != "all"
            or ds.time.name in needed)
        if time_in_play:
            needed.add(ds.time.name)
        names = array_names(ds, sorted(needed), time_in_play)
        return dim_plans, agg_plans, min_day, max_day, n_keys, names, \
            self._plan_routes(agg_plans)

    def _plan_routes(self, agg_plans):
        """Static numeric routes for the dense (non-sketch) aggregations
        plus the '__rows__' group-occupancy count."""
        metas = [G.AggInput(p.spec.name, p.kind, is_int=p.is_int)
                 for p in agg_plans if p.kind not in SKETCH_KINDS]
        metas.append(G.AggInput("__rows__", "count", is_int=True))
        return G.plan_routes(metas)

    def _make_core(self, ds, dim_plans, agg_plans, filter_spec,
                   intervals, min_day, max_day, n_keys, routes,
                   compact_m=None):
        """The dense scan body: scan -> filter -> fused key -> the dense
        group-by tiers. With ``compact_m`` (late materialization) the
        survivors move to a static [M] prefix first and the key build,
        the values and the aggregation run there; gather-heavy conjuncts
        apply on the prefix only, and '__over__' ([1]) counts the live
        rows the budget could not hold. Sketch aggregates follow the dense
        group-by as register ops over the same key and rows."""
        pallas_max = self.config.get(GROUPBY_PALLAS_MAX_KEYS)
        dense_plans = [p for p in agg_plans if p.kind not in SKETCH_KINDS]
        sketch_plans = [p for p in agg_plans if p.kind in SKETCH_KINDS]
        log2m = self.config.get(HLL_LOG2M)
        kll_lanes = self.config.get(QUANTILE_LANES)
        tz = self.config.get(TZ_ID)
        cheap_f, exp_f = (self._split_filter_staged(filter_spec)
                          if compact_m else (filter_spec, None))
        fuse_cse = bool(self.config.get(SHAREDSCAN_FUSION_ENABLED))

        def core(arrays):
            ctx = ScanContext(ds, arrays, min_day, max_day, tz=tz)
            cse, base = _scan_base(ctx, cheap_f, intervals, fuse_cse)
            n_over = None
            if compact_m:
                ctx, cse, base, n_over = _compact(
                    ctx, base, compact_m, exp_f, fuse_cse)
            if dim_plans:
                codes = [p.build(ctx) for p in dim_plans]
                key, _ = G.fuse_keys(codes, [p.card for p in dim_plans])
            else:
                key = torch.zeros_like(base, dtype=torch.int32)
            inputs = [G.AggInput(p.spec.name, p.kind, p.build_values(ctx),
                                 p.build_mask(ctx, cse=cse),
                                 is_int=p.is_int)
                      for p in dense_plans]
            inputs.append(G.AggInput("__rows__", "count", is_int=True))
            out = G.dense_groupby(key, base, n_keys, inputs, routes,
                                  pallas_max)
            for p in sketch_plans:
                out[p.spec.name] = sketch_registers(
                    p, ctx, cse, base, key, n_keys, log2m=log2m,
                    kll_lanes=kll_lanes)
            if n_over is not None:
                out["__over__"] = n_over.reshape(1)
            return out

        return core

    def _cached_program(self, sig, build):
        """Program-cache fetch with per-signature build ownership: a
        second thread wanting the same signature waits for the owner's
        build instead of building twice; different signatures build at
        once."""
        prog = self._programs.get(sig)
        while prog is None:
            with self._compile_lock:
                prog = self._programs.get(sig)
                if prog is not None:
                    break
                ev = self._compiling.get(sig)
                owner = ev is None
                if owner:
                    ev = self._compiling[sig] = threading.Event()
            if owner:
                try:
                    prog = build()
                    with self._compile_lock:
                        self._programs[sig] = prog
                finally:
                    with self._compile_lock:
                        self._compiling.pop(sig, None)
                    ev.set()
                break
            ev.wait()
            prog = self._programs.get(sig)
        return prog

    def _plan_waves(self, ds, names, seg_idx, output_groups, n_aggs):
        """``(segments per wave, waves)`` of one scan on this engine's
        device (``parallel/cost.plan_waves`` under
        ``cost.wave_budget_bytes``)."""
        return C.plan_waves(
            len(seg_idx), 1, C.bytes_per_segment(ds, names),
            C.wave_budget_bytes(self.config, self.device), self.config,
            output_groups, n_aggs, io_budget=C.tier_io_budget(ds, self.config),
            io_seg_bytes=C.tier_io_seg_bytes(ds, names))

    def _run_waves(self, ds, names, seg_idx, spw, core, routes, n_keys,
                   sketch_plans, check=None):
        """Execute the scan in bounded segment waves (double-buffered:
        wave i+1's copy to the device overlaps wave i's compute), merging
        each wave's [K] finals on the host; ``check`` runs at every wave
        boundary. Returns ``(finals, 0)``, or ``(None, overflow)`` when a
        wave's late-materialization budget overflowed: the caller re-runs
        the scan uncompacted."""
        binder = _WaveBinder(ds, names, spw, self.device)
        finals = None
        try:
            for out in binder.stream(
                    core, FU.plan_device_waves(seg_idx, spw, 1), check):
                host = _to_host(out)
                over = host.pop("__over__", None)
                if over is not None and int(over[0]):
                    # this wave's budget was too small: stop burning waves
                    return None, int(over[0])
                f = _finals_from_out(host, routes, n_keys, sketch_plans)
                finals = f if finals is None \
                    else _merge_wave_finals(finals, f, routes, sketch_plans)
        finally:
            self.last_stats["wave_steps"] = binder.steps()
        return finals, 0

    def _bind_arrays(self, ds, names, seg_idx):
        """Fetch-or-build the device tensors a scan binds, cached per
        (datasource, array, segment selection) so repeated queries never
        re-upload host data. ``sdot.engine.device.cache.bytes`` bounds the
        cache, not the scan: an upload that would pass it drops the whole
        cache first, so residency peaks at the cap plus one array."""
        seg_sig = (len(seg_idx), hash(np.asarray(seg_idx).tobytes()))
        cap = int(self.config.get(DEVICE_CACHE_BYTES))
        with self._bind_lock:
            return self._bind_locked(ds, names, seg_idx, seg_sig, cap)

    def _bind_locked(self, ds, names, seg_idx, seg_sig, cap):
        out = {}
        for k in names:
            key = (ds.serial, k, seg_sig)
            dev = self._device_arrays.get(key)
            if dev is None:
                host = build_array(ds, k, seg_idx)
                if self._device_bytes + host.nbytes > cap:
                    # evict BEFORE the upload so peak residency never
                    # exceeds cap + one array
                    self._device_arrays.clear()
                    self._device_bytes = 0
                src = torch.from_numpy(np.ascontiguousarray(host))
                dev = _device_copy_retry(lambda: src.to(self.device))
                self._device_arrays[key] = dev
                self._device_bytes += int(host.nbytes)
            out[k] = dev
        return out

    # -- select and search ----------------------------------------------------
    def _run_select(self, q: S.SelectQuerySpec) -> QueryResult:
        """Raw rows, paged: the filter on the device when the datasource
        has at least ``sdot.select.device.min.rows`` rows (one mask pass,
        a bit-packed transfer), else on the host; the page's values come
        from the store's host copies."""
        ds = self.store.get(q.datasource)
        if ds.is_partial:
            raise not_ported("select over a multi-host partial store",
                             "A.8")
        cols = list(q.columns) or ds.column_names()
        seg_idx = ds.prune_segments(q.intervals, q.filter)
        if len(seg_idx) == 0:
            return QueryResult.empty(cols)
        t = _time.perf_counter()
        mask = None
        if (q.filter is not None or q.intervals is not None) \
                and ds.num_rows >= self.config.get(SELECT_DEVICE_MIN_ROWS):
            mask = self._device_mask(ds, q.filter, q.intervals, seg_idx)
        if mask is None:
            self.last_stats["select_filter"] = "host"
            mask = self._host_mask(ds, q.filter, q.intervals)
        t = _phase("dispatch", t)
        idx = np.nonzero(mask)[0]
        if q.descending:
            idx = idx[::-1]
        page = idx[q.page_offset: q.page_offset + q.page_size]
        data = {c: _host_column_values(ds, c, page) for c in cols}
        _phase("epilogue", t)
        self.last_stats.update({"datasource": ds.name,
                                "rows": int(len(page)),
                                "rows_scanned": int(ds.num_rows)})
        if self.last_stats.get("select_filter") != "host":
            # the device pass reads only the mask's inputs
            mask_cols = set(F.columns_of_filter(q.filter))
            if q.intervals and ds.time is not None:
                mask_cols.add(ds.time.name)
            if mask_cols:
                self.last_stats["bytes_scanned"] = \
                    int(C.bytes_per_segment(ds, sorted(mask_cols))) \
                    * int(len(seg_idx))
        return QueryResult(cols, data)

    def _run_search(self, q: S.SearchQuerySpec) -> QueryResult:
        """Dictionary values of each dimension that contain the needle,
        with their row counts under the filter (host-side occurrence
        counting; NULL rows count for no value)."""
        ds = self.store.get(q.datasource)
        if ds.is_partial:
            raise not_ported("search over a multi-host partial store",
                             "A.8")
        mask = self._host_mask(ds, q.filter, q.intervals)
        needle = q.query if q.case_sensitive else q.query.lower()
        dims_out, vals_out, counts_out = [], [], []
        for dname in q.dimensions:
            dim = ds.dims[dname]
            cand = [i for i, s in enumerate(dim.dictionary)
                    if needle in (s if q.case_sensitive else s.lower())]
            if not cand:
                continue
            eff = mask
            if dim.validity is not None:
                # NULL rows are stored at code 0; they are not occurrences
                # of dictionary[0]
                eff = eff & dim.validity
            counts = np.bincount(dim.codes[eff], minlength=dim.cardinality)
            for c in cand:
                if counts[c] > 0:
                    dims_out.append(dname)
                    vals_out.append(dim.dictionary[c])
                    counts_out.append(int(counts[c]))
        if q.limit is not None:
            dims_out = dims_out[: q.limit]
            vals_out = vals_out[: q.limit]
            counts_out = counts_out[: q.limit]
        self.last_stats.update({"datasource": ds.name,
                                "search_values": len(vals_out)})
        if q.value_output is not None:
            # rewritten from a group-by: project to its output shape
            return QueryResult(
                [q.value_output, q.count_output],
                {q.value_output: np.array(vals_out, dtype=object),
                 q.count_output: np.array(counts_out, dtype=np.int64)})
        return QueryResult(
            ["dimension", "value", "count"],
            {"dimension": np.array(dims_out, dtype=object),
             "value": np.array(vals_out, dtype=object),
             "count": np.array(counts_out, dtype=np.int64)})

    def _device_mask(self, ds: Datasource, filter_spec, intervals,
                     seg_idx) -> Optional[np.ndarray]:
        """The select filter on the device: the filter and interval mask
        over the bound columns (through the array cache, so a repeated
        select reuses resident columns), packed 32 rows to an int32 word
        ([S, R / 32]), one copy to the host, unpacked there. Returns the
        [num_rows] bool mask, or None when the filter does not lower (the
        host path runs)."""
        mins, maxs = ds.segment_time_bounds()
        if ds.time is None:
            min_day = max_day = 0
        else:
            min_day = int(mins[seg_idx].min() // T.MILLIS_PER_DAY)
            max_day = int(maxs[seg_idx].max() // T.MILLIS_PER_DAY)
        needed = set(F.columns_of_filter(filter_spec))
        time_in_play = ds.time is not None and (
            intervals is not None or ds.time.name in needed)
        if time_in_play:
            needed.add(ds.time.name)
        names = array_names(ds, sorted(needed), time_in_play)
        try:
            arrays = self._bind_arrays(ds, names, seg_idx)
            ctx = ScanContext(ds, arrays, min_day, max_day,
                              tz=self.config.get(TZ_ID))
            _, base = _scan_base(ctx, filter_spec, intervals, False)
            words = _to_host({"w": _pack_rows(base)})["w"]
        except (EngineFallback, EC.Unsupported):
            return None
        bits = np.unpackbits(words.astype("<i4", copy=False).view(np.uint8),
                             bitorder="little").view(bool) \
            .reshape(len(seg_idx), ds.padded_rows)
        mask = np.zeros(ds.num_rows, dtype=bool)
        for i, si in enumerate(seg_idx):
            s = ds.segments[int(si)]
            mask[s.start_row: s.end_row] = bits[i, : s.num_rows]
        self.last_stats["select_filter"] = "device"
        return mask

    def _host_mask(self, ds: Datasource, filter_spec, intervals):
        """The row mask evaluated on the host from the store's copies."""
        n = ds.num_rows
        mask = np.ones(n, dtype=bool)
        if intervals is not None and ds.time is not None:
            ms = ds.time.millis
            im = np.zeros(n, dtype=bool)
            for lo, hi in intervals:
                im |= (ms >= lo) & (ms < hi)
            mask &= im
        if filter_spec is not None:
            env = {c: _host_column_values(ds, c, None)
                   for c in sorted(F.columns_of_filter(filter_spec))}
            mask &= host_eval.eval_pred3(filter_to_expr(filter_spec), env)
        return mask

    def clear_caches(self):
        """Drop the device-resident columns (the next query re-uploads),
        the late-materialization overflow memo and the result cache."""
        self._device_arrays.clear()
        self._device_bytes = 0
        self._compact_overflowed.clear()
        self.result_cache.clear()


def _scan_base(ctx, filter_spec, intervals, fuse_cse):
    """``(cse, base)``: row validity, the filter and the interval mask of
    one scan; ``cse`` (a ``planner/fusion.CSECache`` over ``ctx`` when
    ``fuse_cse``, else None) memoizes the sub-masks of the filter for the
    aggregates' own filters."""
    cse = FU.CSECache(ctx) if fuse_cse else None
    base = ctx.row_valid()
    fm = cse.lower(filter_spec) if cse is not None \
        else F.lower_filter(filter_spec, ctx)
    if fm is not None:
        base = base & fm
    im = F.interval_mask(intervals, ctx)
    if im is not None:
        base = base & im
    return cse, base


def _compact(ctx, base, m, exp_f, fuse_cse):
    """Late materialization inside a core: ``(compacted ctx, its cse,
    base [m], overflow)``. The live rows move to the [m] prefix
    (``ops/scan.compact_keep``); every later read gathers through it. The
    CSE cache is rebuilt over the compacted context, so no full-width
    mask leaks past this point; the staged gather-heavy conjuncts
    (``exp_f``) apply to the prefix only. ``overflow`` ([] int32, on the
    device) counts the live rows past ``m``."""
    keep, n_live = compact_keep(base, m)
    n_over = torch.clamp(n_live - m, min=0).to(torch.int32)
    ctx = CompactScanContext(ctx.ds, ctx.arrays, ctx.min_day, ctx.max_day,
                             ctx.tz, keep=keep)
    cse = FU.CSECache(ctx) if fuse_cse else None
    base = base.reshape(-1)[keep]
    if exp_f is not None:
        em = cse.lower(exp_f) if cse is not None \
            else F.lower_filter(exp_f, ctx)
        if em is not None:
            base = base & em
    return ctx, cse, base, n_over


_CMP = {"=": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def _having_mask(having_dev, out, routes) -> torch.Tensor:
    """Device bool [n_keys]: the group holds rows AND the HAVING
    comparison passes, exactly (an ``i64`` or ``f64`` route compares in
    its own type); a NULL min/max metric makes the comparison unknown,
    so the group fails."""
    name, op, lit = having_dev
    v = out[name]
    m = _CMP[op](v, torch.tensor(lit, dtype=v.dtype, device=v.device))
    nm = G.route_null_mask(routes[name], out)
    if nm is not None:
        m = m & ~nm
    return m & (out["__rows__"] > 0)


def _having_gather(table, mask, k, n_keys, full):
    """Device HAVING's second dispatch: the groups that travel. ``full``:
    the whole table in key order with the failing groups' '__rows__'
    zeroed (in int64), so the host's occupancy filter drops them.
    Otherwise the first ``k`` of the passing groups in ascending key
    order, then the failing ones in ascending order (the order of
    ``lax.top_k`` over the 0/1 mask), with their key ids
    ('__topk_idx__')."""
    if full:
        g = dict(table)
        g["__rows__"] = table["__rows__"] * mask.to(table["__rows__"].dtype)
        return g
    idx, _ = compact_keep(mask, k)
    g = _gather_rows(table, idx, n_keys)
    g["__topk_idx__"] = idx
    return g


def _pack_rows(base: torch.Tensor) -> torch.Tensor:
    """A [S, R] bool mask as [S, R / 32] int32 words, row ``32 w + b`` in
    bit ``b`` of word ``w`` (bit 31 carries the sign; distinct powers of
    two sum without overflow)."""
    s, r = base.shape
    shifts = torch.arange(32, dtype=torch.int32, device=base.device)
    return (base.reshape(s, r // 32, 32).to(torch.int32) << shifts).sum(
        -1, dtype=torch.int32)


def _cache_repr(q) -> str:
    """repr(q) without its per-request QueryContext (a query id or a
    timeout never changes what runs)."""
    try:
        return repr(dataclasses.replace(q, context=None))
    except (TypeError, ValueError):
        return repr(q)


# CUDA runtime errors after which the context is unusable for the rest of
# the process ("sticky" errors), by the runtime's message and by its code
# (the port's kernels report ``CUDA error <code>`` from their launch check)
_STICKY_CUDA_MESSAGES = (
    "illegal memory access", "device-side assert", "unspecified launch "
    "failure", "launch timed out", "illegal instruction",
    "misaligned address", "invalid program counter",
    "hardware stack error", "uncorrectable ecc", "invalid address space",
    "no cuda-capable device", "cuda driver version is insufficient",
    "device(s) is/are busy or unavailable")
# cudaErrorNoDevice 100, cudaErrorECCUncorrectable 214,
# cudaErrorIllegalAddress 700, cudaErrorLaunchTimeout 702,
# cudaErrorAssert 710, cudaErrorHardwareStackError 714 ...
# cudaErrorLaunchFailure 719
_STICKY_CUDA_CODES = frozenset(
    (100, 214, 700, 702, 710, 714, 715, 716, 717, 718, 719))
_CUDA_CODE = re.compile(r"cuda error (\d+)")


def _is_backend_loss(e: BaseException) -> bool:
    """Whether ``e`` says the device is gone for this process: a sticky
    CUDA error (an illegal address, a device-side assert, a launch
    failure, an uncorrectable ECC error; the runtime's ``CUDA error: ...``
    or a kernel's ``CUDA error <code>``) or a driver that reports no
    device. Not a loss: a device out-of-memory error, a shape or type
    error, a kernel that fails to build, a launch error that leaves the
    context usable."""
    if isinstance(e, (EngineFallback, torch.cuda.OutOfMemoryError)) \
            or not isinstance(e, RuntimeError):
        return False
    from spark_druid_olap_tpu_torch.cluster.broker import ClusterError
    if isinstance(e, ClusterError):
        # a shard unreachable over the NETWORK says nothing about the
        # local device — strict mode must surface it, not demote it to
        # the host tier
        return False
    s = str(e).lower()
    if "cuda error" not in s and "cuda-capable" not in s \
            and "cuda driver" not in s:
        return False
    m = _CUDA_CODE.search(s)
    if m is not None:
        return int(m.group(1)) in _STICKY_CUDA_CODES
    return any(t in s for t in _STICKY_CUDA_MESSAGES)


def _loss_site(e: BaseException) -> str:
    """Where a device loss surfaced: ``B1`` or ``B2`` for the port's
    kernels' launch checks, ``copy`` for a host-to-device copy through
    :func:`_device_copy_retry`, else the innermost function of the port
    the error passed through (``module.function``)."""
    s = str(e)
    if s.startswith("dense_groupby kernel launch failed"):
        return "B1"
    if s.startswith("wave kernel launch failed"):
        return "B2"
    site, tb = "?", e.__traceback__
    while tb is not None:
        code = tb.tb_frame.f_code
        mod = tb.tb_frame.f_globals.get("__name__", "")
        if code.co_name == "_device_copy_retry":
            return "copy"
        if mod.startswith("spark_druid_olap_tpu_torch"):
            site = f"{mod.rsplit('.', 1)[-1]}.{code.co_name}"
        tb = tb.tb_next
    return site


def _probe_device_alive(device, timeout_s: float = 10.0) -> bool:
    """Whether ``device`` answers a trivial dispatch and a synchronize
    within the deadline, probed from a daemon thread (a hung dispatch
    must never hang the session)."""
    result = []

    def work():
        try:
            r = torch.arange(8, device=device).sum().item()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            result.append(r == 28)
        except Exception:  # noqa: BLE001 — any failure: still down
            result.append(False)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    th.join(timeout_s)
    return bool(result and result[0])


def _device_copy_retry(fn):
    """A host-to-device copy (or device allocation) with backoff on a
    device out-of-memory error, which memory freed by concurrent
    statements can cure (the JAX engine's ``_device_put_retry``, whose
    RESOURCE_EXHAUSTED this is); every other error, a sticky one above
    all, raises at once."""
    from spark_druid_olap_tpu_torch.utils.retry import retry_on_error
    return retry_on_error(
        fn, "device copy", tries=3, start=0.5,
        retryable=lambda e: isinstance(e, torch.cuda.OutOfMemoryError))


def _key_space(dim_plans) -> int:
    """The product of the dimensions' cardinalities (a Python int)."""
    n = 1
    for p in dim_plans:
        n *= int(p.card)
    return n


def _rows_of(ds, seg_idx) -> int:
    """Rows of the selected segments: what a scan can select at most."""
    return int(sum(ds.segments[int(si)].num_rows for si in seg_idx))


def _phase(name: str, t0: float) -> float:
    """Charge the host time since ``t0`` to phase ``name``
    (``utils/phases``); returns now."""
    t = _time.perf_counter()
    PH.add(name, t - t0)
    return t


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device outputs -> numpy, in ONE device-to-host copy: every output
    keeps its width and travels as bytes in one buffer (each part padded
    to 8 bytes, so every numpy view is aligned), copied into pinned host
    memory on the card, so a dispatch syncs once, not once per
    aggregate."""
    meta, parts, off = [], [], 0
    for name, t in out.items():
        # a one-element view may keep a stride other than 1 and still
        # count as contiguous; a byte view needs stride 1
        t = t.reshape(-1)
        if t.stride(0) != 1:
            t = t.clone(memory_format=torch.contiguous_format)
        b = t.view(torch.uint8)
        pad = -b.numel() % 8
        meta.append((name, off, b.numel(), t.dtype))
        parts += [b, b.new_zeros(pad)] if pad else [b]
        off += b.numel() + pad
    flat = torch.cat(parts)
    if flat.is_cuda:
        buf = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        buf.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
    else:
        buf = flat
    raw = buf.numpy()
    return {name: raw[o: o + nbytes].view(_NP_DTYPE[dtype])
            for name, o, nbytes, dtype in meta}


_NP_DTYPE = {torch.int64: np.int64, torch.int32: np.int32,
             torch.bool: np.bool_, torch.float64: np.float64,
             torch.float32: np.float32}


def _finals_from_out(host, routes, n_keys, sketch_plans=()):
    """Route outputs on the host -> exact final [n_keys] numpy arrays per
    aggregation, plus each sketch's [n_keys, width] register block (the
    copy to the host flattened it)."""
    finals = {name: np.asarray(G.combine_route(r, host, n_keys))
              for name, r in routes.items()}
    for p in sketch_plans:
        finals[p.spec.name] = host[p.spec.name].reshape(n_keys, -1)
    return finals


def _top_k(score: torch.Tensor, k: int):
    """The ``k`` largest scores and their indices, ties in index order
    (the order of ``lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _gather_rows(out, idx, n_keys):
    """Gather every per-key output at ``idx``."""
    return {name: t.reshape(n_keys, -1)[idx].reshape(-1)
            for name, t in out.items()}


def _topk_score(route, out, ascending, valid):
    """The selection score of the dense and hashed top-k epilogues. Rank
    order matches the host epilogue's: real scores, then occupied groups
    whose metric is NULL (min/max sentinel), then invalid (unoccupied)
    keys at -inf, so NULL-metric groups still fill an under-subscribed
    LIMIT (nulls last)."""
    sc = G.route_score(route, out)
    if ascending:
        sc = -sc
    nm = G.route_null_mask(route, out)
    if nm is not None:
        sc = torch.where(nm, -torch.finfo(sc.dtype).max, sc)
    return torch.where(valid, sc, float("-inf"))


def _topk_gather(out, routes, topk, n_keys):
    """Dense device top-k: select ``k_sel`` candidate keys of the groups
    that hold rows by score and gather every output there, with the key
    ids ('__topk_idx__') and the scores ('__topk_score__')."""
    metric, k_sel, ascending = topk
    sc = _topk_score(routes[metric], out, ascending, out["__rows__"] > 0)
    vals, idx = _top_k(sc, k_sel)
    g = _gather_rows(out, idx, n_keys)
    g["__topk_idx__"] = idx
    g["__topk_score__"] = vals
    return g


def _hash_topk_gather(out, routes, topk, T):
    """Hashed device top-k: score the occupied slots, keep the best
    ``k_sel`` (unoccupied slots at -inf fill any remainder and are
    dropped by the host occupancy filter)."""
    metric, k_sel, ascending = topk
    occ = out["__tkhi__"] != H.EMPTY
    sc = _topk_score(routes[metric], out, ascending, occ)
    vals, idx = _top_k(sc, k_sel)
    g = _gather_rows(out, idx, T)
    g["__topk_score__"] = vals
    return g


def _score_cast_exact(route, vlo: float, vhi: float) -> bool:
    """True when route_score is bit-exact for every metric value in
    [vlo, vhi] and no value outside that range can round onto a value
    inside it (strict bounds: a boundary tie in score space is then a
    true value tie)."""
    if route.tag == "f64":
        return True
    if route.tag == "i64":
        return -(2.0 ** 53) < vlo and vhi < 2.0 ** 53
    return False


def _topk_selection_exact(limit, topk, route, scores, data) -> bool:
    """True when the device candidate selection provably contains the
    exact ordered-limit result; an exact-contract GroupBy re-runs without
    the device epilogue when this is False (a TopN never checks: its
    contract is approximate, like Druid's topN engine).

    Every key the device did not transfer scored at most the ``k_sel``-th
    best score (the cutoff), and its exact value exceeds its score by at
    most the score's rounding. So the result is exact when the LIMIT-th
    emitted row's exact value clears the cutoff by more than that."""
    metric, k_sel, ascending = topk
    cutoff = float(scores[-1]) if len(scores) else float("-inf")
    if cutoff != cutoff:
        return False                       # NaN scores: cannot reason
    if cutoff == float("-inf"):
        # an unoccupied (-inf) slot made the candidate set: every
        # occupied key was transferred, so the selection is complete
        return True
    n = int(limit.limit)
    if n <= 0:
        return True
    vals = data.get(metric)
    if vals is None:
        return False
    vals = np.asarray(vals)
    if len(vals) < n:
        # occupied keys were excluded (finite cutoff) yet the LIMIT is
        # under-subscribed: an excluded key might belong in the result
        return False
    v_k = vals[n - 1]
    if v_k is None or (isinstance(v_k, float) and v_k != v_k):
        return False      # NULL boundary row: excluded NULLs could tie
    try:
        s_k = float(v_k)
    except (TypeError, ValueError):
        return False
    if ascending:
        s_k = -s_k
    c_val = -cutoff if ascending else cutoff        # cutoff in VALUE domain
    vlo = min(s_k if not ascending else -s_k, c_val)
    vhi = max(s_k if not ascending else -s_k, c_val)
    if _score_cast_exact(route, vlo, vhi):
        # scores near the boundary are bit-exact: strictly better is
        # always safe, and an exact tie is safe when the primary metric
        # is the only order column (tied keys are interchangeable answers
        # under SQL's unspecified tie order)
        return s_k > cutoff \
            or (s_k == cutoff and len(limit.columns) == 1)
    base = max(abs(cutoff), abs(s_k), 1.0)
    eps = float(np.spacing(np.float64(base)))
    return (s_k - cutoff) > 64.0 * eps


def _hash_partial(raw, routes, T) -> list:
    """One hash table's host outputs -> ``[(packed keys, finals)]`` of its
    occupied slots, or ``[]`` when none is occupied (the JAX package's
    ``_hash_chip_partials`` for one device)."""
    out = dict(raw)
    khi = out.pop("__tkhi__")
    klo = out.pop("__tklo__")
    occ = khi != H.EMPTY
    if not occ.any():
        return []
    return [(H.pack_key(khi[occ], klo[occ]),
             {name: np.asarray(G.combine_route(r, out, T))[occ]
              for name, r in routes.items()})]


def _merge_hash_partials(parts, routes):
    """Merge the waves' hash-table partials by key on the host:
    ``(keys in ascending order, finals)``. Sums and counts add exactly
    (int64 / float64 finals, in wave order), min / max keep their
    sentinels (the JAX package's ``_merge_hash_partials``, as a sort and
    segmented reductions; one table's keys are distinct, so one partial
    only sorts)."""
    if not parts:
        return np.zeros(0, np.int64), {name: np.zeros(0, np.float64)
                                       for name in routes}
    keys = np.concatenate([k for k, _ in parts])
    # stable: a key's values stay in wave order
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    starts = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
    merged = {}
    for name, r in routes.items():
        v = np.concatenate([f[name] for _, f in parts])[order]
        if len(parts) > 1:
            op = {"min": np.minimum, "max": np.maximum}.get(r.kind, np.add)
            v = op.reduceat(v, starts)
        merged[name] = v
    return keys[starts], merged


def _merge_wave_finals(acc, new, routes, sketch_plans=()):
    """Cross-wave merge of dense finals (the JAX package's
    ``_merge_wave_finals``): sums and counts add exactly (int64 / float64
    finals), min / max keep their empty-group sentinels, and sketch
    registers take their union: HLL the elementwise max, theta's k-mins
    the elementwise min, KLL the lex-min survivor and the exact count sum
    (``ops/kll.merge``)."""
    kinds = {p.spec.name: p.kind for p in sketch_plans}
    for name, v in new.items():
        r = routes.get(name)
        if r is None:                       # sketch registers [K, width]
            kind = kinds[name]
            if kind == "kll":
                acc[name] = kll_merge(acc[name], v)
            elif kind == "theta":
                acc[name] = np.minimum(acc[name], v)
            else:
                acc[name] = np.maximum(acc[name], v)
        elif r.kind == "min":
            acc[name] = np.minimum(acc[name], v)
        elif r.kind == "max":
            acc[name] = np.maximum(acc[name], v)
        else:
            acc[name] = acc[name] + v
    return acc


class _WaveBinder:
    """Uncached binds of one scan's waves (the JAX engine's
    ``_bind_wave``) and the double-buffered loop over them (its
    ``_run_waves``). A wave binds its segments padded to ``spw`` with dead
    segments (``ops/scan.build_wave_array``), so every wave has the shape
    its program was built for. Waves never enter the bind cache: wave
    mode exists because the scan exceeds what one wave may hold.

    On a cuda device the host gathers a wave into one of two pinned
    staging sets, used in turn, and a copy stream moves it to the card
    while the compute stream still runs the wave before. The wave's device
    tensors are allocated on the copy stream; the compute stream waits on
    the copy's event before the wave's launch, and each tensor is recorded
    on the compute stream, so the allocator never hands its memory out
    while the compute stream may still read it. Each wave keeps its
    timings (``steps``): host bind ms, bytes copied, and on cuda the
    copy's and the compute span's device ms (CUDA events)."""

    def __init__(self, ds, names, spw, device):
        self.ds, self.names, self.spw = ds, list(names), int(spw)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._steps: List[dict] = []
        self._staging: List[Optional[Dict[str, torch.Tensor]]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(self.device)

    def _host_buffers(self, slot):
        """The host arrays a wave builds into: staging set ``slot`` of
        two, allocated once per loop and reused every other wave (pinned
        on cuda; on the CPU the wave's program reads it directly, and has
        finished with it before the set's next wave is built)."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy is done
        if self._staging[slot] is None:
            shape = (self.spw, self.ds.padded_rows)
            self._staging[slot] = {
                k: torch.empty(shape, dtype=_torch_dtype(array_dtype(
                    self.ds, k)), pin_memory=self.cuda) for k in self.names}
        return self._staging[slot]

    def bind_wave(self, segs):
        """Build one wave on the host and start its copy to the device:
        ``(device tensors by array name, the wave's step record)``."""
        t0 = _time.perf_counter()
        slot = len(self._steps) % 2
        bufs = self._host_buffers(slot)
        # a tiered datasource's chunks are copied into the staging as
        # they fault: pinned for this wave's build only
        pins = getattr(self.ds, "wave_pins", None)
        with pins() if pins is not None else contextlib.nullcontext():
            for k, b in bufs.items():
                build_wave_array(self.ds, k, segs, b.numpy())
        step = {"segments": int(len(segs)),
                "h2d_bytes": int(sum(b.nbytes for b in bufs.values()))}
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with torch.cuda.stream(self.copy_stream):
                arrays = _device_copy_retry(lambda: {
                    k: torch.empty_like(b, device=self.device)
                    for k, b in bufs.items()})
                # the events span the copies only, not the allocation
                ev[0].record()
                for k, b in bufs.items():
                    arrays[k].copy_(b, non_blocking=True)
                ev[1].record()
            self._copied[slot] = step["_copy"] = ev[1]
            step["_copy_start"] = ev[0]
        else:
            arrays = bufs
        step["bind_ms"] = (_time.perf_counter() - t0) * 1e3
        PH.add("bind", step["bind_ms"] / 1e3)
        self._steps.append(step)
        return arrays, step

    def _launch(self, prog, wave):
        arrays, step = wave
        if not self.cuda:
            return prog(arrays)
        cs = torch.cuda.current_stream(self.device)
        cs.wait_event(step["_copy"])
        for a in arrays.values():
            a.record_stream(cs)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(cs)
        out = prog(arrays)
        ev[1].record(cs)
        step["_compute"] = ev
        return out

    def tier_prefetch(self, wave_segs, i):
        """Enqueue wave ``i``'s cold-tier chunks on a tiered datasource's
        prefetcher so they load behind the current wave's compute (the
        JAX engine's ``_tier_prefetch``). A no-op on in-memory datasources
        and past the last wave."""
        pf = getattr(self.ds, "tier_prefetch", None)
        if pf is not None and i < len(wave_segs):
            pf(self.names, wave_segs[i])

    def stream(self, prog, wave_segs, check=None):
        """Yield each wave's outputs of ``prog`` in wave order. Wave i is
        launched, then wave i+1 bound (its host build and its copy
        overlap wave i's compute), then wave i's outputs yielded: the
        caller's copy of them to the host is the loop's sync point.
        ``check`` (a cancel or deadline) runs before each launch; however
        the loop ends, it waits for the copies still in flight out of the
        pinned staging before the staging can be freed."""
        self.tier_prefetch(wave_segs, 1)
        cur = self.bind_wave(wave_segs[0])
        try:
            for i in range(len(wave_segs)):
                if check is not None:
                    check()     # per-wave boundary
                t0 = _time.perf_counter()
                out = self._launch(prog, cur)
                self.tier_prefetch(wave_segs, i + 2)
                b0 = _time.perf_counter()
                cur = self.bind_wave(wave_segs[i + 1]) \
                    if i + 1 < len(wave_segs) else None
                bind_s = _time.perf_counter() - b0
                try:
                    yield out
                finally:
                    # the bind above charged its own phase
                    PH.add("dispatch", _time.perf_counter() - t0 - bind_s)
        finally:
            for ev in self._copied:
                if ev is not None:
                    ev.synchronize()

    def steps(self) -> List[dict]:
        """Per wave: segments, host bind ms, bytes copied and, on cuda,
        ``h2d_ms`` and ``compute_ms`` (None where the wave was not
        launched); waits for the events it reads."""
        out = []
        for st in self._steps:
            d = {k: v for k, v in st.items() if not k.startswith("_")}
            if self.cuda:
                st["_copy"].synchronize()
                d["h2d_ms"] = st["_copy_start"].elapsed_time(st["_copy"])
                ev = st.get("_compute")
                if ev:
                    ev[1].synchronize()
                d["compute_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
            out.append(d)
        return out


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _decode_agg_value(ds, p, r, v, partial_sketches=False) -> np.ndarray:
    """Final per-group route values -> output column (dtype-faithful; min/max
    empty-group sentinels become nulls); a sketch's selected registers ->
    its estimates, or, on a cluster historical (``partial_sketches``), the
    raw ``[G, m]`` register block: the broker merges registers across
    shards (max / min / minsum) and finalizes the estimate once
    (cluster/merge.py), which makes the distributed estimate EQUAL the
    single-engine one."""
    if p.kind in SKETCH_KINDS:
        return np.asarray(v) if partial_sketches else decode_sketch(p, v)
    if p.kind in ("min", "max"):
        if r.tag == "i64":
            sent = G.I64_MAX if p.kind == "min" else G.I64_MIN
            empty = v == sent
        else:
            empty = np.abs(v) >= 3.0e38
        if p.spec.kind == "anyvalue" or p.dim_codes:
            return _decode_anyvalue(ds, p.spec.field, v, empty)
        if empty.any():
            if r.tag == "i64" and \
                    np.abs(np.where(empty, 0, v)).max(initial=0) >= 2**53:
                # f64 NaN-nulls would round these; keep exact ints + None
                out = v.astype(object)
                out[empty] = None
                return out
            return np.where(empty, np.nan, v).astype(np.float64)
        if np.issubdtype(p.out_dtype, np.integer) and r.tag == "i64":
            return v.astype(np.int64)
        if np.issubdtype(p.out_dtype, np.integer):
            return np.round(v).astype(np.int64)
        return v.astype(np.float64)
    if np.issubdtype(p.out_dtype, np.integer):
        if np.issubdtype(v.dtype, np.integer):
            return v.astype(np.int64)
        return np.rint(v).astype(np.int64)
    return v.astype(np.float64)


def _decode_anyvalue(ds: Datasource, field: str, v: np.ndarray,
                     empty: np.ndarray) -> np.ndarray:
    """Decode a column from its max-aggregated device representation
    (dictionary code for dims, days for dates)."""
    kind = ds.column_kind(field)
    if kind == ColumnKind.DIM:
        codes = np.where(empty, 0, v).astype(np.int64)
        vals = ds.dims[field].dictionary[
            np.clip(codes, 0, max(ds.dims[field].cardinality - 1, 0))]
        if empty.any():
            vals = np.where(empty, None, vals)
        return vals
    if kind == ColumnKind.DATE:
        days = np.where(empty, 0, v).astype(np.int64)
        out = days.astype("datetime64[D]")
        if empty.any():
            out = np.where(empty, np.datetime64("NaT"), out)
        return out
    if kind == ColumnKind.LONG:
        if empty.any():
            return np.where(empty, np.nan, v).astype(np.float64)
        return np.rint(v).astype(np.int64)
    return np.where(empty, np.nan, v).astype(np.float64)


def _host_column_values(ds: Datasource, name: str,
                        idx: Optional[np.ndarray]):
    """Decoded host values of a column (optionally a row subset), read
    from the store's host copies and never from the device cache (the
    JAX executor's ``_host_column_values`` on a complete store)."""
    if name in ds.dims:
        col = ds.dims[name]
        codes = col.codes if idx is None else col.codes[idx]
        vals = col.dictionary[codes.astype(np.int64)]
        if col.validity is not None:
            v = col.validity if idx is None else col.validity[idx]
            vals = np.where(v, vals, None)
        return vals
    if name in ds.metrics:
        m = ds.metrics[name]
        vals = m.values if idx is None else m.values[idx]
        if m.kind == ColumnKind.DATE:
            return vals.astype("datetime64[D]")
        if m.kind == ColumnKind.LONG:
            out = vals.astype(np.int64)
            if m.validity is not None:
                v = m.validity if idx is None else m.validity[idx]
                out = np.where(v, out.astype(np.float64), np.nan)
            return out
        # keep f32 (storage dtype): python-float literals then compare in
        # f32 under NumPy weak promotion, as the device path does
        out = vals
        if m.validity is not None:
            v = m.validity if idx is None else m.validity[idx]
            out = np.where(v, out, np.float32(np.nan))
        return out
    if ds.time is not None and name == ds.time.name:
        t = ds.time
        ms = t.millis if idx is None else \
            t.days[idx].astype(np.int64) * T.MILLIS_PER_DAY + t.ms_in_day[idx]
        return ms.astype("datetime64[ms]")
    raise KeyError(name)


def _neg_key(k: np.ndarray):
    if np.issubdtype(k.dtype, np.number):
        return -k
    if np.issubdtype(k.dtype, np.datetime64):
        return -(k.astype(np.int64))
    # descending strings: invert via negated rank
    _, inv = np.unique(k, return_inverse=True)
    return -inv


def filter_to_expr(f: S.FilterSpec) -> E.Expr:
    """FilterSpec -> Expr for host-side evaluation (the JAX executor's
    ``filter_to_expr``)."""
    if isinstance(f, S.SelectorFilter):
        if f.value is None:
            return E.IsNull(E.Column(f.dimension))
        return E.Comparison("=", E.Column(f.dimension), E.Literal(f.value))
    if isinstance(f, S.BoundFilter):
        parts = []
        c = E.Column(f.dimension)
        if f.lower is not None:
            parts.append(E.Comparison(">" if f.lower_strict else ">=", c,
                                      E.Literal(f.lower)))
        if f.upper is not None:
            parts.append(E.Comparison("<" if f.upper_strict else "<=", c,
                                      E.Literal(f.upper)))
        return E.And(tuple(parts)) if len(parts) != 1 else parts[0]
    if isinstance(f, S.InFilter):
        return E.InList(E.Column(f.dimension), tuple(f.values))
    if isinstance(f, S.PatternFilter):
        if f.kind == "like":
            return E.Like(E.Column(f.dimension), f.pattern)
        if f.kind == "contains":
            return E.Like(E.Column(f.dimension), f"%{f.pattern}%")
        raise EngineFallback("regex filter on host path")
    if isinstance(f, S.NullFilter):
        return E.IsNull(E.Column(f.dimension), negated=f.negated)
    if isinstance(f, S.LogicalFilter):
        subs = tuple(filter_to_expr(x) for x in f.fields)
        if f.op == "and":
            return E.And(subs) if subs else E.Literal(True)
        if f.op == "or":
            return E.Or(subs)
        return E.Not(subs[0])
    if isinstance(f, S.ExprFilter):
        return f.expr
    if isinstance(f, S.SpatialFilter):
        import math
        parts = []
        for ax, lo, hi in zip(f.axes, f.min_coords, f.max_coords):
            c = E.Column(ax)
            if lo is not None and math.isfinite(lo):
                parts.append(E.Comparison(">=", c, E.Literal(lo)))
            if hi is not None and math.isfinite(hi):
                parts.append(E.Comparison("<=", c, E.Literal(hi)))
        return E.And(tuple(parts)) if len(parts) != 1 else (
            parts[0] if parts else E.Literal(True))
    raise EngineFallback(f"filter {type(f).__name__}")
