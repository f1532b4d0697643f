"""Cost-model calibration from measured wall times.

Port of the single-device part of ``spark_druid_olap_tpu/tools/calibrate.py``
(``default_shapes``, ``_measure``, ``measure_samples``, ``fit`` and
``calibrate``), kept inside the PyTorch package, which imports nothing of
the JAX package. Probe group-bys run on the engine's device, their warm
executions are timed, and the model's single-device terms are fit by least
squares:

    single  ~= rows * scan_c + groups * 16 * byte_c

Units become SECONDS (the defaults are unit-free hand-set numbers). The
sharded side (a mesh context's timings, ``calibrate(..., mesh_ctx=)``, and
:func:`fit` over more than one device) waits for ROADMAP A.8. The
per-primitive unit costs the engine's gates
read are measured by ``parallel/cost.measure_unit_costs`` instead of the
JAX package's ``calibrate_primitives``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.parallel.executor import not_ported
from spark_druid_olap_tpu_torch.utils.config import (
    COST_COMPILE, COST_PER_BYTE_TRANSPORT, COST_PER_ROW_SCAN)


def default_shapes(datasource: str, ds) -> List[S.GroupByQuerySpec]:
    """Three probe shapes with distinct (rows x groups) profiles: a
    low-cardinality full scan, a filtered scan, and a high-cardinality
    group-by (merge-term heavy)."""
    dims = sorted(ds.dims, key=lambda d: ds.cardinality(d) or 0)
    if not dims:
        raise ValueError("calibration needs at least one dimension")
    lo = dims[0]
    hi = dims[-1]
    metric = next((m for m in ds.metrics), None)
    aggs = [S.AggregationSpec("count", "n")]
    if metric is not None:
        kind = "doublesum" if ds.column_kind(metric).name == "DOUBLE" \
            else "longsum"
        aggs.append(S.AggregationSpec(kind, "s", field=metric))
    aggs = tuple(aggs)
    filt = None
    d0 = ds.dims[lo]
    if len(d0.dictionary):
        filt = S.SelectorFilter(lo, str(d0.dictionary[0]))
    return [
        S.GroupByQuerySpec(datasource=datasource,
                           dimensions=(S.DimensionSpec(lo, lo),),
                           aggregations=aggs),
        S.GroupByQuerySpec(datasource=datasource,
                           dimensions=(S.DimensionSpec(lo, lo),),
                           aggregations=aggs, filter=filt),
        S.GroupByQuerySpec(datasource=datasource,
                           dimensions=(S.DimensionSpec(hi, hi),),
                           aggregations=aggs),
    ]


def _measure(engine, q, reps: int) -> Tuple[float, dict]:
    engine.execute(q)                       # warm (kernel build + upload)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.execute(q)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), dict(engine.last_stats)


def measure_samples(single_engine, mesh_engine, shapes,
                    reps: int = 3) -> List[dict]:
    """One sample per shape: measured single-device wall seconds plus
    the model's inputs (rows, groups, n_aggs). A mesh engine's sharded
    timings are ROADMAP A.8."""
    if mesh_engine is not None:
        raise NotImplementedError(
            "sharded calibration samples not ported yet (ROADMAP A.8)")
    out = []
    for q in shapes:
        t1, st1 = _measure(single_engine, q, reps)
        out.append({"rows": int(st1.get("rows_scanned", 0)),
                    "groups": max(1, int(st1.get("groups", 1))),
                    "n_aggs": max(1, len(S.query_aggregations(q))),
                    "single_s": t1, "spec": q})
    return out


def fit(samples: List[dict], n_dev: int = 1) -> Dict[str, float]:
    """Least-squares fit of the single-device constants (clamped
    positive) from the samples' single-device timings. The sharded terms
    (``n_dev`` > 1) are ROADMAP A.8."""
    if n_dev > 1:
        raise not_ported("fitting the sharded cost terms (n_dev > 1)", "A.8")
    rows = np.array([s["rows"] for s in samples], dtype=np.float64)
    grp = np.array([s["groups"] for s in samples], dtype=np.float64)
    t1 = np.array([s["single_s"] for s in samples], dtype=np.float64)

    a1 = np.stack([rows, grp * 16.0], axis=1)
    (scan_c, byte_c), *_ = np.linalg.lstsq(a1, t1, rcond=None)
    scan_c = max(float(scan_c), 1e-12)
    byte_c = max(float(byte_c), 1e-13)
    return {COST_PER_ROW_SCAN.key: scan_c,
            COST_PER_BYTE_TRANSPORT.key: byte_c,
            COST_COMPILE.key: 0.0}


def calibrate(ctx, datasource: Optional[str] = None, reps: int = 3,
              mesh_ctx=None, apply: bool = True) -> Dict[str, float]:
    """Fit the single-device cost constants on the context's device and
    (optionally) apply them to the session config: on a card,
    ``sdot.querycostmodel.historical.processing.cost`` becomes seconds per
    scanned row and ``transport.cost`` seconds per result byte. A
    ``mesh_ctx`` (the sharded side) is ROADMAP A.8."""
    if mesh_ctx is not None:
        raise NotImplementedError(
            "calibrating the sharded cost terms (mesh_ctx) not ported yet "
            "(ROADMAP A.8)")
    datasource = datasource or sorted(ctx.store.names())[0]
    ds = ctx.store.get(datasource)
    samples = measure_samples(ctx.engine, None,
                              default_shapes(datasource, ds), reps)
    fitted = fit(samples)
    if apply:
        for k, v in fitted.items():
            ctx.config.set(k, v)
    return fitted
