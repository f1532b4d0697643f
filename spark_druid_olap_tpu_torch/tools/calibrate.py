"""Cost-model calibration from measured wall times.

Port of ``spark_druid_olap_tpu/tools/calibrate.py`` (``default_shapes``,
``_measure``, ``measure_samples``, ``fit`` and ``calibrate``), kept
inside the PyTorch package, which imports nothing of the JAX package.
Probe group-bys run on the engine's device and, given a mesh context,
sharded over its slots; their warm executions are timed, and the model's
terms are fit by least squares:

    single  ~= rows * scan_c + groups * 16 * byte_c
    sharded ~= rows * scan_c / (n_dev * eff) + groups * n_aggs * merge_c
               + groups * 16 * byte_c

where ``n_dev`` counts the devices the scan splits across
(``parallel/mesh.scan_devices``: the mesh's distinct cards, as
``parallel/cost.mesh_estimate`` prices it). Units become SECONDS (the
defaults are unit-free hand-set numbers). Only timings where the mesh
engine really sharded fit the sharded terms (``merge.cost`` and
``shard.efficiency``); a mesh whose slots share one card splits no scan,
and fits none. The per-primitive unit costs the engine's
gates read are measured by ``parallel/cost.measure_unit_costs`` instead
of the JAX package's ``calibrate_primitives``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.parallel.mesh import scan_devices
from spark_druid_olap_tpu_torch.utils.config import (
    COST_COMPILE, COST_MODEL_ENABLED, COST_PER_BYTE_TRANSPORT,
    COST_PER_ROW_MERGE, COST_PER_ROW_SCAN, COST_SHARD_EFFICIENCY)


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
    """One sample per shape: measured single-device (and, given a mesh
    engine, sharded) wall seconds plus the model's inputs (rows, groups,
    n_aggs)."""
    out = []
    for q in shapes:
        t1, st1 = _measure(single_engine, q, reps)
        sample = {"rows": int(st1.get("rows_scanned", 0)),
                  "groups": max(1, int(st1.get("groups", 1))),
                  "n_aggs": max(1, len(S.query_aggregations(q))),
                  "single_s": t1, "spec": q}
        if mesh_engine is not None:
            t8, st8 = _measure(mesh_engine, q, reps)
            sample["sharded_s"] = t8
            sample["sharded_really"] = bool(st8.get("sharded"))
        out.append(sample)
    return out


def fit(samples: List[dict], n_dev: int = 1) -> Dict[str, float]:
    """Least-squares fit of the model constants (clamped positive): the
    single-device terms from every sample, the sharded terms (``n_dev``
    > 1) from the samples whose mesh engine really sharded."""
    rows = np.array([s["rows"] for s in samples], dtype=np.float64)
    grp = np.array([s["groups"] for s in samples], dtype=np.float64)
    naggs = np.array([s["n_aggs"] for s in samples], dtype=np.float64)
    t1 = np.array([s["single_s"] for s in samples], dtype=np.float64)

    a1 = np.stack([rows, grp * 16.0], axis=1)
    (scan_c, byte_c), *_ = np.linalg.lstsq(a1, t1, rcond=None)
    scan_c = max(float(scan_c), 1e-12)
    byte_c = max(float(byte_c), 1e-13)
    out = {COST_PER_ROW_SCAN.key: scan_c,
           COST_PER_BYTE_TRANSPORT.key: byte_c,
           COST_COMPILE.key: 0.0}
    if any("sharded_s" in s for s in samples) and n_dev > 1:
        # only timings where the mesh engine REALLY sharded inform the
        # sharded terms (a single-device run would fit eff ~= 1/n_dev)
        t8 = np.array([s["sharded_s"]
                       if s.get("sharded_really", True)
                       and "sharded_s" in s else np.nan
                       for s in samples])
        ok = ~np.isnan(t8)
        if not ok.any():
            return out
        a8 = np.stack([rows[ok], grp[ok] * naggs[ok]], axis=1)
        resid = t8[ok] - grp[ok] * 16.0 * byte_c
        (alpha, merge_c), *_ = np.linalg.lstsq(a8, resid, rcond=None)
        merge_c = max(float(merge_c), 1e-13)
        # alpha = scan_c / (n_dev * eff)
        eff = scan_c / (max(float(alpha), 1e-15) * n_dev)
        out[COST_PER_ROW_MERGE.key] = merge_c
        out[COST_SHARD_EFFICIENCY.key] = float(np.clip(eff, 0.01, 1.0))
    return out


def calibrate(ctx, datasource: Optional[str] = None, reps: int = 3,
              mesh_ctx=None, apply: bool = True) -> Dict[str, float]:
    """Fit the cost constants on the context's device and (optionally)
    apply them to the session config (and to ``mesh_ctx``'s): on a card,
    ``sdot.querycostmodel.historical.processing.cost`` becomes seconds per
    scanned row and ``transport.cost`` seconds per result byte. A
    ``mesh_ctx`` supplies the sharded side: its probes run with the cost
    model off, so they really shard."""
    datasource = datasource or sorted(ctx.store.names())[0]
    ds = ctx.store.get(datasource)
    shapes = default_shapes(datasource, ds)
    mesh_engine = mesh_ctx.engine if mesh_ctx is not None else None
    n_dev = scan_devices(mesh_engine.mesh) if mesh_engine is not None \
        else 1
    prev_cm = None
    if mesh_ctx is not None:
        prev_cm = mesh_ctx.config.get(COST_MODEL_ENABLED)
        mesh_ctx.config.set(COST_MODEL_ENABLED.key, False)
    try:
        samples = measure_samples(ctx.engine, mesh_engine, shapes, reps)
    finally:
        if mesh_ctx is not None:
            mesh_ctx.config.set(COST_MODEL_ENABLED.key, prev_cm)
    fitted = fit(samples, n_dev)
    if apply:
        for k, v in fitted.items():
            ctx.config.set(k, v)
            if mesh_ctx is not None:
                mesh_ctx.config.set(k, v)
    return fitted
