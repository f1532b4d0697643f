"""Broadcast hash join: build once, probe in the wave loop.

Port of ``spark_druid_olap_tpu/join/broadcast.py`` on one device. The build
side (under ``sdot.join.broadcast.max.bytes`` by the planner's estimate)
materializes on the host, canonicalizes its keys and becomes one set of
device tensors: the open-addressing table of ``ops/hash_join.py`` plus the
payload and group columns. The probe side streams through the engine's
segment waves: waves sized by ``parallel/cost.plan_waves``; one wave binds
through the engine's cached ``_bind_arrays`` (repeated joins never re-upload
columns), more waves through its double-buffered ``_WaveBinder``.

Per wave the probe canonicalizes its keys, probes and expands the matches to
``[N, C]`` pairs, masks them with the residual, and aggregates the pairs
through ``ops/groupby.dense_groupby``. On a cuda device that takes kernel B1
for a group space of at most ``sdot.engine.groupby.pallas.max.keys`` keys,
where the JAX package always scatters (it plans the join's routes without
its Pallas bound): a deliberate departure with the same answers (ROADMAP
§C).

On an engine with a mesh (``parallel/mesh.py``) the join takes the JAX
package's mesh branch when ``sdot.mesh.enabled`` holds, one process runs
and the probe side has at least one segment per slot: the table goes to
every slot's device, the probe waves are sharded (the engine's sharded
bind, or its wave binder per slot), each slot probes and aggregates its
share, and the slots' partials merge on the root device
(``parallel/meshexec.py``). ``last_stats["join"]`` reports ``devices``
and ``mesh`` (``sharded``, or the reason it declined: ``no-mesh``,
``disabled``, ``multihost``, ``few-segments``).

Cold-tier pins (a side that is a tiered datasource, ``tier/``): every
chunk the join faults on its thread is held out of eviction's reach while
the join reads it. The build side is pinned for the whole build, from its
materialization until its tensors are on the device; a one-wave probe for
its bind; a waved probe one wave at a time, through the ``wave_pins`` scope
the wave binder opens around each wave's build. The JAX package pins both
sides from the build's upload to the end of the wave loop (ROADMAP §C).

Device residency of the build table is a checked acquire / release pair
(``BuildLedger``): no decline or exception leaves phantom build bytes in
the gauge.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops import hash_join as HJ
from spark_druid_olap_tpu_torch.ops.hash_join import JoinUnsupported
from spark_druid_olap_tpu_torch.ops.scan import (
    NULL_VALID_PREFIX,
    ROW_VALID_KEY,
    array_dtype,
    array_names,
)
from spark_druid_olap_tpu_torch.parallel import cost as C
from spark_druid_olap_tpu_torch.parallel import meshexec as MX
from spark_druid_olap_tpu_torch.parallel import multihost as MH
from spark_druid_olap_tpu_torch.parallel.mesh import mesh_size
from spark_druid_olap_tpu_torch.utils.config import (
    GROUPBY_PALLAS_MAX_KEYS,
    MESH_ENABLED,
    JOIN_MAX_MATCHES,
)

#: dense group-key ceiling for the join group-by (a wider group space
#: declines to the host)
MAX_GROUP_KEYS = 1 << 22


# =============================================================================
# build-table residency ledger
# =============================================================================

class _BuildToken:
    __slots__ = ("nbytes", "released")

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)
        self.released = False


class BuildLedger:
    """Device-byte accounting for broadcast build tables while a join
    holds them resident (table + payload tensors)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.outstanding_bytes = 0
        self.peak_bytes = 0
        self.acquires = 0

    def acquire_build(self, nbytes: int) -> _BuildToken:
        tok = _BuildToken(nbytes)
        with self._lock:
            self.acquires += 1
            self.outstanding_bytes += tok.nbytes
            self.peak_bytes = max(self.peak_bytes, self.outstanding_bytes)
        return tok

    def release_build(self, tok: _BuildToken) -> None:
        with self._lock:
            if not tok.released:
                tok.released = True
                self.outstanding_bytes -= tok.nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"outstanding_bytes": self.outstanding_bytes,
                    "peak_bytes": self.peak_bytes,
                    "acquires": self.acquires}


#: process-wide gauge (surfaced through stats["join"]["build_ledger"])
LEDGER = BuildLedger()


# =============================================================================
# host-side helpers
# =============================================================================

def null_mask(vals) -> np.ndarray:
    """NaN / None-coded null mask of a host column (pandas convention)."""
    return np.asarray(pd.isna(np.asarray(vals)), dtype=bool)


def factorize_group(vals: np.ndarray):
    """Host group-column factorization: sorted non-null uniques + codes
    with the null lane at ``len(uniques)``. Returns
    ``(codes int32, card_with_null, decoder)``."""
    vals = np.asarray(vals)
    nulls = null_mask(vals)
    nn = vals[~nulls]
    if nn.dtype == object or nn.dtype.kind in ("U", "S"):
        uniq = np.unique(nn.astype(str)) if len(nn) else \
            np.empty(0, dtype=object)
        pos = np.searchsorted(uniq, vals.astype(str)) if len(uniq) else \
            np.zeros(len(vals), dtype=np.int64)
    else:
        uniq = np.unique(nn)
        pos = np.searchsorted(uniq, np.where(nulls, uniq[0] if len(uniq)
                                             else 0, vals)) \
            if len(uniq) else np.zeros(len(vals), dtype=np.int64)
    card = len(uniq)
    codes = np.where(nulls, card, np.clip(pos, 0, max(0, card - 1))) \
        .astype(np.int32)

    def decode(cs: np.ndarray) -> np.ndarray:
        cs = np.asarray(cs, dtype=np.int64)
        isnull = cs >= card
        if uniq.dtype == object or uniq.dtype.kind in ("U", "S"):
            out = np.empty(len(cs), dtype=object)
            out[~isnull] = uniq[np.clip(cs[~isnull], 0,
                                        max(0, card - 1))].astype(str) \
                if card else None
            out[isnull] = None
            return out
        out = uniq[np.clip(cs, 0, max(0, card - 1))] if card else \
            np.zeros(len(cs))
        if isnull.any():
            out = out.astype(np.float64)
            out[isnull] = np.nan
        return out

    return codes, card + 1, decode


def numeric_payload(vals: np.ndarray):
    """Host agg / residual column -> (device value array, valid mask).
    Integers keep the exact int64 route; strings decline (the planner
    should have caught them). The JAX package's 32-bit branch has no
    counterpart: the card carries int64 and float64."""
    vals = np.asarray(vals)
    nulls = null_mask(vals)
    if vals.dtype == object or vals.dtype.kind in ("U", "S"):
        raise JoinUnsupported("string column in a numeric join payload")
    if vals.dtype.kind in ("i", "u"):
        return vals.astype(np.int64), ~nulls
    return np.where(nulls, 0.0, vals).astype(np.float64), ~nulls


def agg_is_int(arg: Optional[E.Expr], kindof) -> bool:
    """Static integer-route hint: a bare integer column aggregates on the
    exact integer route; any compound expression goes float."""
    return isinstance(arg, E.Column) and kindof(arg.name) == "int"


def sentinel_of(route: G.Route):
    """The empty-group value of a min / max route (None for the rest)."""
    return G.sentinel(route) if route.kind in ("min", "max") else None


def finalize_agg(spec_fn: str, out_name: str, acc: Dict[str, np.ndarray],
                 routes: Dict[str, G.Route]) -> np.ndarray:
    """One aggregation's exact cross-wave accumulator -> final column with
    SQL null semantics (empty-group sum / avg / min / max -> NULL)."""
    if spec_fn == "count":
        return np.asarray(acc[out_name], dtype=np.int64)
    if spec_fn in ("sum", "avg"):
        raw = np.asarray(acc[out_name])
        vc = np.asarray(acc["__vc__" + out_name], dtype=np.int64)
        if spec_fn == "avg":
            return np.where(vc > 0, raw / np.maximum(vc, 1), np.nan) \
                .astype(np.float64)
        if (vc == 0).any():
            return np.where(vc > 0, raw.astype(np.float64), np.nan)
        return raw
    # min / max: the route sentinel marks all-null groups
    val = np.asarray(acc[out_name])
    sent = sentinel_of(routes[out_name])
    if sent is not None and (val == sent).any():
        return np.where(val == sent, np.nan, val.astype(np.float64))
    return val


def combine_wave(acc: Dict[str, np.ndarray], wave_out: Dict[str, object],
                 routes: Dict[str, G.Route], n_keys: int) -> None:
    """Fold one wave's outputs into the exact host accumulator (int64 /
    float64 adds for sums and counts, sentinel-preserving elementwise
    min / max for extrema)."""
    np_out = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in wave_out.items()}
    for name, route in routes.items():
        arr = G.combine_route(route, np_out, n_keys)
        cur = acc.get(name)
        if cur is None:
            acc[name] = arr
        elif route.kind == "min":
            acc[name] = np.minimum(cur, arr)
        elif route.kind == "max":
            acc[name] = np.maximum(cur, arr)
        else:
            acc[name] = cur + arr


# =============================================================================
# the broadcast executor
# =============================================================================

@contextlib.contextmanager
def _pinned(tier):
    """Pin scope on this thread over one side's hot set: every chunk the
    thread faults inside it stays out of eviction's reach until it ends
    (nothing for a side held in memory)."""
    if tier is None:
        yield
        return
    tok = tier.acquire_pins()
    try:
        yield
    finally:
        tier.release_pins(tok)


def execute_broadcast(ctx, plan) -> Tuple[Dict[str, np.ndarray], dict]:
    """Run ``plan`` (planner/joinplan.JoinPlan) on the broadcast tier.

    Returns ``(grouped data, join stats dict)``: group columns keyed by
    query name, agg columns keyed by output name, all finalized; the
    planner's shared epilogue does HAVING / ORDER BY / LIMIT / projection.
    The build side's chunks stay pinned until the build is on the device
    (``build_pins``, closed there) or the call ends.
    """
    with contextlib.ExitStack() as build_pins:
        build_pins.enter_context(_pinned(_tier(ctx, plan.build.ds)))
        return _execute_broadcast(ctx, plan, build_pins)


def _tier(ctx, name: str):
    """The hot set a tiered datasource faults through, else None."""
    return getattr(ctx.store._datasources.get(name), "tier", None)


def _execute_broadcast(ctx, plan, build_pins: contextlib.ExitStack):
    from spark_druid_olap_tpu_torch.parallel.executor import (
        EngineFallback, _WaveBinder, _to_host)
    from spark_druid_olap_tpu_torch.planner import fusion as FU
    from spark_druid_olap_tpu_torch.planner import host_exec
    from spark_druid_olap_tpu_torch.utils import host_eval
    eng = ctx.engine
    conf = ctx.config
    store = ctx.store
    device = eng.device
    ds = store.get(plan.probe.ds)
    if getattr(ds, "is_partial", False):
        raise JoinUnsupported("probe side is a multi-host partial store")

    # ---- build side: materialize, filter, canonicalize ----------------------
    bcols = plan.build_cols()
    bdf = host_exec.datasource_frame(ctx, plan.build.ds, columns=bcols)
    if plan.build_filter is not None:
        env = {c: bdf[c].to_numpy() for c in bdf.columns}
        bdf = bdf[host_eval.eval_pred3(plan.build_filter, env)]
    bdf = bdf.reset_index(drop=True)

    key_pcols = [pc for pc, _ in plan.keys]
    key_bcols = [bc for _, bc in plan.keys]
    bvals = [bdf[c].to_numpy() for c in key_bcols]
    bvalid = [~null_mask(v) for v in bvals]
    uniques, comps, keep = HJ.build_key_components(bvals, bvalid)
    cards = [len(u) for u in uniques]
    if HJ.key_domain(cards) >= HJ.MAX_KEY_DOMAIN:
        raise JoinUnsupported(
            f"composite key domain {HJ.key_domain(cards)} exceeds int32")
    bdf = bdf[keep].reset_index(drop=True)
    fused = HJ.fuse_components(comps, cards)
    table = HJ.build_table(fused, conf.get(JOIN_MAX_MATCHES))
    n_build = table.n_build
    C_w = max(1, table.max_count)

    # probe-side key maps (dictionary LUT / numeric searchsorted)
    keymaps = []
    for pc, uniq in zip(key_pcols, uniques):
        dcol = ds.dims.get(pc)
        if dcol is not None:
            if uniq.dtype != object and uniq.dtype.kind not in ("U", "S"):
                raise JoinUnsupported(
                    f"join key {pc!r} is a dimension but the build side "
                    f"is numeric")
            keymaps.append(HJ.dim_keymap(dcol.dictionary, uniq))
        else:
            if uniq.dtype == object or uniq.dtype.kind in ("U", "S"):
                raise JoinUnsupported(
                    f"join key {pc!r} is numeric but the build side is "
                    f"a string column")
            keymaps.append(HJ.numeric_keymap(uniq, array_dtype(ds, pc)))

    # ---- build payload / group columns --------------------------------------
    pay, payv = {}, {}
    for c in plan.build_value_cols():
        pay[c], payv[c] = numeric_payload(bdf[c].to_numpy())
    bgrp: Dict[str, Tuple[np.ndarray, int, object]] = {}
    group_meta: List[Tuple[str, int, object]] = []
    for g in plan.group_by:
        side, phys = plan.colside[g]
        if side == "build":
            codes, cardn, dec = factorize_group(bdf[phys].to_numpy())
            bgrp[g] = (codes, cardn, dec)
            group_meta.append((g, cardn, dec))
        else:
            dcol = ds.dims.get(phys)
            card = dcol.cardinality

            def dec_dim(cs, _d=dcol, _card=card):
                cs = np.asarray(cs, dtype=np.int64)
                out = np.empty(len(cs), dtype=object)
                nn = cs < _card
                out[nn] = _d.decode(cs[nn])
                out[~nn] = None
                return out

            group_meta.append((g, card + 1, dec_dim))
    gcards = [m[1] for m in group_meta]
    n_keys = 1
    for c in gcards:
        n_keys *= c
    n_keys = max(1, n_keys)
    if n_keys > MAX_GROUP_KEYS:
        raise JoinUnsupported(
            f"join group-by cardinality {n_keys} exceeds the dense "
            f"tier's ceiling {MAX_GROUP_KEYS}")

    if n_build == 0:
        # an empty build side (after its filter) joins to nothing: skip the
        # device loop (a gather over zero-length payloads is ill-formed)
        # and emit the empty grouped shape, or the one global-aggregate row
        data0: Dict[str, np.ndarray] = {}
        if group_meta:
            for g, _, dec in group_meta:
                data0[g] = dec(np.empty(0, dtype=np.int64))
            for spec in plan.aggs:
                data0[spec.out] = (np.zeros(0, dtype=np.int64)
                                   if spec.fn == "count"
                                   else np.zeros(0, dtype=np.float64))
        else:
            for spec in plan.aggs:
                data0[spec.out] = (np.zeros(1, dtype=np.int64)
                                   if spec.fn == "count"
                                   else np.full(1, np.nan))
        js0 = {"mode": "broadcast", "build_rows": 0, "build_bytes": 0,
               "table_slots": int(table.n_slots), "match_width": 0,
               "waves": 0, "segments_per_wave": 0, "devices": 0,
               "mesh": "empty-build", "groups": 0,
               "build_ledger": LEDGER.stats()}
        return data0, js0

    # ---- probe plan: columns, waves, mesh decision --------------------------
    pcols = sorted(plan.probe_cols())
    names = array_names(ds, pcols, need_time_ms=False)
    n_segments = ds.num_segments
    mesh_reason = "no-mesh"
    n_dev = 1
    if mesh_size(eng.mesh) > 1:
        n = mesh_size(eng.mesh)
        if not bool(conf.get(MESH_ENABLED)):
            mesh_reason = "disabled"
        elif MH.is_multihost():
            mesh_reason = "multihost"
        elif n_segments < n:
            mesh_reason = "few-segments"
        else:
            n_dev, mesh_reason = n, "sharded"
    mesh = eng.mesh if n_dev > 1 else None
    spw, n_waves = C.plan_waves(
        n_segments, n_dev, C.bytes_per_segment(ds, names),
        C.wave_budget_bytes(conf, device, mesh), conf,
        output_groups=n_keys, n_aggs=len(plan.aggs),
        io_budget=C.tier_io_budget(ds, conf),
        io_seg_bytes=C.tier_io_seg_bytes(ds, names))

    # ---- routes -------------------------------------------------------------
    pallas_max = int(conf.get(GROUPBY_PALLAS_MAX_KEYS))

    def kindof(qname: str) -> str:
        side, phys = plan.colside[qname]
        if side == "probe":
            if phys in ds.dims:
                return "dim"
            k = ds.column_kind(phys)
            return "int" if k.value == "long" else "float"
        v = pay.get(phys)
        if v is None:
            return "dim"
        return "int" if v.dtype.kind in ("i", "u") else "float"

    meta_inputs = [G.AggInput(ROW_VALID_KEY, "count")]
    for spec in plan.aggs:
        kind = "sum" if spec.fn == "avg" else spec.fn
        if kind == "count":
            meta_inputs.append(G.AggInput(spec.out, "count"))
        else:
            meta_inputs.append(G.AggInput(
                spec.out, kind, is_int=agg_is_int(spec.arg, kindof)))
            if kind == "sum":
                meta_inputs.append(G.AggInput("__vc__" + spec.out,
                                              "count"))
    routes = G.plan_routes(meta_inputs)

    # ---- the per-wave core --------------------------------------------------
    dimlk = ds.dims.get

    def jdim(qname: str):
        side, phys = plan.colside.get(qname, (None, None))
        return ds.dims.get(phys) if side == "probe" else None

    def core(arrays, tdev):
        rowv = arrays[ROW_VALID_KEY]
        device = rowv.device

        def pget(phys):
            v = arrays[phys]
            if phys in ds.dims:
                v = v.to(torch.int32)
            nv = arrays.get(NULL_VALID_PREFIX + phys)
            valid = rowv if nv is None else torch.logical_and(rowv, nv)
            return v, valid

        keep = rowv
        fm = HJ.pred_mask(plan.probe_filter, pget, dimlk, device)
        if fm is not None:
            keep = torch.logical_and(keep, fm)
        kvals, kvalids = [], []
        for pc in key_pcols:
            v, ok = pget(pc)
            kvals.append(v)
            kvalids.append(torch.logical_and(ok, keep))
        kdevs = [tdev["keys"][i] for i in range(len(keymaps))]
        key, kvalid = HJ.canonical_key(keymaps, kdevs, kvals, kvalids)
        key = key.reshape(-1)
        kvalid = kvalid.reshape(-1)
        start, count = HJ.probe(
            tdev["table"], key, kvalid, n_slots=table.n_slots,
            shift=table.shift, max_disp=table.max_disp)
        bidx, mvalid = HJ.expand(tdev["table"], start, count,
                                 width=C_w, n_build=n_build)
        bidx = bidx.long()
        shape = (key.shape[0], C_w)

        def jget(qname):
            side, phys = plan.colside[qname]
            if side == "probe":
                v, ok = pget(phys)
                return (v.reshape(-1)[:, None],
                        torch.logical_and(ok.reshape(-1)[:, None], mvalid))
            return (tdev["pay"][phys][bidx],
                    torch.logical_and(tdev["payv"][phys][bidx], mvalid))

        pairmask = mvalid
        if plan.residual is not None:
            pairmask = torch.logical_and(
                pairmask, HJ.pred_mask(plan.residual, jget, jdim, device))

        gcodes = []
        for g in plan.group_by:
            side, phys = plan.colside[g]
            if side == "build":
                gcodes.append(tdev["bgrp"][g][bidx])
            else:
                code, ok = pget(phys)
                card = ds.dims[phys].cardinality
                gc = torch.where(ok, code, card)
                gcodes.append(torch.broadcast_to(
                    gc.reshape(-1)[:, None], shape))
        if gcodes:
            gkey, _ = G.fuse_keys(gcodes, gcards)
        else:
            gkey = torch.zeros(shape, dtype=torch.int32, device=key.device)
        gkey = gkey.reshape(-1)
        flatmask = pairmask.reshape(-1)

        inputs = [G.AggInput(ROW_VALID_KEY, "count", mask=flatmask)]
        for spec in plan.aggs:
            kind = "sum" if spec.fn == "avg" else spec.fn
            if kind == "count":
                if spec.arg is None:
                    m = flatmask
                else:
                    _, ok = jget(_arg_col(spec.arg))
                    m = torch.logical_and(pairmask, ok).reshape(-1)
                inputs.append(G.AggInput(spec.out, "count", mask=m))
                continue
            v, ok = HJ._num(spec.arg, jget, jdim, device)
            v = torch.broadcast_to(v, shape).reshape(-1)
            m = torch.logical_and(pairmask, ok).reshape(-1)
            inputs.append(G.AggInput(spec.out, kind, values=v, mask=m,
                                     is_int=agg_is_int(spec.arg, kindof)))
            if kind == "sum":
                inputs.append(G.AggInput("__vc__" + spec.out, "count",
                                         mask=m))
        return G.dense_groupby(gkey, flatmask, n_keys, inputs, routes,
                               pallas_max)

    # ---- device residency + the wave loop -----------------------------------
    tree = {"table": table.device_tree(),
            "keys": {i: km.device_tree() for i, km in enumerate(keymaps)},
            "pay": pay,
            "payv": payv,
            "bgrp": {g: codes for g, (codes, _, _) in bgrp.items()}}
    build_bytes = int(sum(a.nbytes for sub in tree.values()
                          for a in _leaves(sub)))
    acc: Dict[str, np.ndarray] = {}
    # the table once on every device a slot sits on
    table_devices = list(dict.fromkeys(mesh or (device,)))
    btok = LEDGER.acquire_build(build_bytes * len(table_devices))
    try:
        tdevs = {d: _to_device(tree, d) for d in table_devices}
        build_pins.close()      # the build is on the device
        seg_idx = np.arange(n_segments, dtype=np.int64)
        if mesh is None:
            def prog(slot_arrays):
                return core(slot_arrays[0], tdevs[device])
        else:
            # each slot probes its share; the partials merge on the root
            lane = MX.Lane(routes, [], n_keys)
            prog_sharded = MX.build_sharded_program(
                eng, lambda a: [core(a, tdevs[a[ROW_VALID_KEY].device])],
                [lane])

            def prog(slot_arrays):
                return prog_sharded(slot_arrays)[0]
        try:
            if n_waves == 1:
                with _pinned(_tier(ctx, plan.probe.ds)):
                    arrays = eng._bind_arrays(ds, names, seg_idx, n_dev)
                combine_wave(acc, _to_host(prog(arrays)), routes, n_keys)
            else:
                binder = _WaveBinder(ds, names, spw, device, mesh)
                for out in binder.stream(
                        prog, FU.plan_device_waves(seg_idx, spw, 1)):
                    combine_wave(acc, _to_host(out), routes, n_keys)
        except EngineFallback as e:
            raise JoinUnsupported(str(e)) from e
    finally:
        LEDGER.release_build(btok)

    # ---- finalize -----------------------------------------------------------
    rows = np.asarray(acc[ROW_VALID_KEY], dtype=np.int64)
    idx = np.nonzero(rows > 0)[0]
    if not group_meta:
        idx = np.arange(1)     # global aggregate: always one row

    codes = G.unfuse_key(idx, gcards) if group_meta else []
    data: Dict[str, np.ndarray] = {}
    for (g, _, dec), cs in zip(group_meta, codes):
        data[g] = dec(cs)
    for spec in plan.aggs:
        data[spec.out] = finalize_agg(spec.fn, spec.out, acc, routes)[idx]
    js = {
        "mode": "broadcast",
        "build_rows": int(n_build),
        "build_bytes": build_bytes,
        "table_slots": int(table.n_slots),
        "match_width": int(C_w),
        "waves": int(n_waves),
        "segments_per_wave": int(spw),
        "devices": int(n_dev),
        "mesh": mesh_reason,
        "groups": int(len(idx)),
        "build_ledger": LEDGER.stats(),
    }
    return data, js


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, device):
    """The build tree's numpy leaves as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _arg_col(e: E.Expr) -> str:
    if isinstance(e, E.Column):
        return e.name
    raise JoinUnsupported("count() over a compound expression")
