"""Shard-aligned partitioned join: hash-partition exchange + local joins.

Port of ``spark_druid_olap_tpu/join/partitioned.py``. The broadcast tier
caps out at ``sdot.join.broadcast.max.bytes`` of build table; past that
the cluster re-shards BOTH sides on the join key so every key lands on
exactly one node and each node joins only aligned partitions:

1. **Partition hop** — the broker asks every shard owner (over the
   normal guarded RPC path: breakers, health marks) to filter its shard,
   drop null-key rows, and tag each surviving row with a partition id
   (``partition_ids`` — a deterministic value hash both sides compute
   identically, strings by crc32, numerics through float64, so probe row
   and build row with equal keys always land in the same partition).
   Rows come back as normal SDW1 frames.
2. **Exec hop** — the broker regroups rows by partition and ships each
   partition's (probe, build) pair to one node as an ``SDJ1`` frame
   (``wire.encode_join_exec``); the node runs :func:`local_join` — the
   same ``ops/hash_join.py`` probe and expansion the broadcast tier uses,
   as torch tensors on the node's device — and returns per-group
   partials.
3. **Merge** — the broker folds partials through the SAME exact merge
   the scatter path uses (``cluster/merge.py``): Python-int sums, NaN /
   None-aware min/max, so distributed answers match local ones.

The partition hash (:func:`_col_hash`, :func:`partition_ids`) is the JAX
package's numpy, copied: a cluster may mix nodes of both packages, and a
probe row tagged on one package's node must meet its build row tagged on
the other's. Every frame is the JAX package's byte for byte, with one
deliberate departure: a partial SUM (and an avg's total) over float
values accumulates in float64 here, where the JAX package sums the
stored float32 values in float32 (about 1e-7 relative over 50,000 rows);
so a partitioned float sum agrees with the broadcast tier's float64 sum
to rtol 1e-9 (ROADMAP §C).

Every byte that crosses the wire for the join is counted exactly —
hop-1 response frames plus hop-2 request frames — and surfaced as
``stats["join"]["shuffle_bytes"]`` (and the broker's
``join_shuffle_bytes`` counter), priced by the cost model like
interconnect bytes. Any RPC or node failure raises
:class:`JoinUnsupported`; the planner then falls back to the broker's
local broadcast join (the broker holds the full store), mirroring the
scatter path's local-fallback posture.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from spark_druid_olap_tpu_torch.cluster import wire as WIRE
from spark_druid_olap_tpu_torch.ir import serde as SERDE
from spark_druid_olap_tpu_torch.ops import hash_join as HJ
from spark_druid_olap_tpu_torch.ops.hash_join import JoinUnsupported
from spark_druid_olap_tpu_torch.utils.config import JOIN_PARTITIONS

_MIX = np.uint64(0xFF51AFD7ED558CCD)
_STEP = np.uint64(1000003)


# =============================================================================
# side-independent partition hash
# =============================================================================

def _col_hash(vals: np.ndarray) -> np.ndarray:
    """Per-row uint64 hash of one key column. Strings hash their utf-8
    crc32; numerics go THROUGH float64 first so an int32 probe key and
    an int64 (or float) build key with equal value hash identically."""
    vals = np.asarray(vals)
    if vals.dtype == object or vals.dtype.kind in ("U", "S"):
        return np.fromiter(
            (zlib.crc32(str(v).encode("utf-8")) for v in vals),
            dtype=np.uint64, count=len(vals))
    x = vals.astype(np.float64).view(np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= _MIX
    x ^= x >> np.uint64(29)
    return x


def partition_ids(key_cols: List[np.ndarray], n_parts: int) -> np.ndarray:
    """Deterministic partition id per row from the key column tuple."""
    h = np.zeros(len(key_cols[0]) if key_cols else 0, dtype=np.uint64)
    for vals in key_cols:
        h = h * _STEP ^ _col_hash(vals)
    return (h % np.uint64(max(1, n_parts))).astype(np.int64)


# =============================================================================
# historical side: partition + local exec handlers
# =============================================================================

def partition_request(ctx, req: dict) -> bytes:
    """Hop 1 on a shard owner: filter one shard store, drop null-key
    rows, tag partition ids. Returns an SDW1 frame of the ship columns
    plus ``__part__``."""
    from spark_druid_olap_tpu_torch.planner import host_exec
    from spark_druid_olap_tpu_torch.utils import host_eval
    store_name = str(req["store"])
    keys = [str(k) for k in req["keys"]]
    ship = [str(c) for c in req["ship"]]
    read = set(ship) | set(keys) | set(str(c) for c in req.get("read", []))
    n_parts = int(req["npartitions"])
    df = host_exec.datasource_frame(ctx, store_name, columns=read)
    if req.get("filter") is not None:
        flt = SERDE.expr_from_dict(req["filter"])
        env = {c: df[c].to_numpy() for c in df.columns}
        df = df[host_eval.eval_pred3(flt, env)]
    kvals = [df[k].to_numpy() for k in keys]
    if kvals:
        keep = ~np.logical_or.reduce([pd.isna(np.asarray(v))
                                      for v in kvals])
        df = df[keep]
        kvals = [v[keep] for v in kvals]
    df = df.reset_index(drop=True)
    cols = list(dict.fromkeys(ship + keys))
    data = {c: df[c].to_numpy() for c in cols}
    data["__part__"] = partition_ids(kvals, n_parts)
    return WIRE.encode_result(cols + ["__part__"], data,
                              {"rows": int(len(df))})


def _canon_probe_keys(uniques, kvals):
    """Host canonicalization of exchanged probe keys against the build
    uniques: component positions (-1 miss), mixed-radix fuse, valid."""
    comps, valid = [], None
    for uniq, vals in zip(uniques, kvals):
        vals = np.asarray(vals)
        if uniq.dtype == object or uniq.dtype.kind in ("U", "S"):
            u = uniq.astype(str)
            v = vals.astype(str)
        else:
            u = uniq
            v = vals.astype(u.dtype)
        if len(u) == 0:
            comp = np.full(len(v), -1, dtype=np.int64)
        else:
            pos = np.searchsorted(u, v)
            pos_c = np.clip(pos, 0, len(u) - 1)
            comp = np.where(u[pos_c] == v, pos_c, -1)
        ok = comp >= 0
        valid = ok if valid is None else (valid & ok)
        comps.append(comp)
    cards = [len(u) for u in uniques]
    fused = np.zeros(len(comps[0]) if comps else 0, dtype=np.int64)
    for comp, card in zip(comps, cards):
        fused = fused * max(1, card) + np.where(comp >= 0, comp, 0)
    return fused.astype(np.int64), (valid if valid is not None
                                    else np.zeros(0, dtype=bool))


def _match_pairs(table: HJ.HashTable, pk: np.ndarray, pvalid: np.ndarray,
                 width: int, device: torch.device):
    """Probe and expand on ``device`` -> host ``(probe rows, build rows)``
    of every match, in row-major order of the ``[n_probe, width]``
    expansion (``np.nonzero``, as the JAX package reads its expansion)."""
    tdev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in table.device_tree().items()}
    start, count = HJ.probe(
        tdev, torch.from_numpy(pk.astype(np.int32)).to(device),
        torch.from_numpy(np.asarray(pvalid, dtype=bool)).to(device),
        n_slots=table.n_slots, shift=table.shift, max_disp=table.max_disp)
    bidx, mvalid = HJ.expand(tdev, start, count, width=width,
                             n_build=table.n_build)
    mvalid = mvalid.cpu().numpy()
    bidx = bidx.cpu().numpy()
    pi, lane = np.nonzero(mvalid)
    return pi, bidx[pi, lane]


def _sum_cell(nv: np.ndarray):
    """A partial SUM over the non-null values ``nv``: float values
    accumulate in float64 (the JAX package sums float32 in float32),
    integers and Python objects as they are."""
    if nv.dtype.kind == "f":
        nv = nv.astype(np.float64)
    tot = nv.sum()
    return tot.item() if isinstance(tot, np.generic) else tot


def local_join(spec: dict, probe: Tuple[List[str], Dict[str, np.ndarray]],
               build: Tuple[List[str], Dict[str, np.ndarray]],
               device=None):
    """Join one aligned partition pair on ``device`` (the node's) and
    return per-group partials: group VALUE columns (query names, ``None``
    for null) + per-agg object columns (exact Python ints / floats,
    ``None`` for null) + ``__vc__<agg>`` counts for avg.

    The probe path is ``ops/hash_join.py``'s ``probe`` / ``expand`` on
    the build table's tensors moved to ``device``, over the exchanged
    flat arrays; the surviving pairs' partial aggregation runs host-side
    (it is O(matched pairs), already past the data-reduction point).
    There is no default device: the caller names the node's."""
    if device is None:
        raise ValueError("local_join needs the node's device")
    device = torch.device(device)
    from spark_druid_olap_tpu_torch.utils import host_eval
    _, pdata = probe
    _, bdata = build
    keys = [(str(a), str(b)) for a, b in spec["keys"]]
    colside = {q: (str(s), str(c)) for q, (s, c) in spec["colside"].items()}
    group_by = [str(g) for g in spec["group_by"]]
    aggs = spec["aggs"]
    n_probe = len(next(iter(pdata.values()))) if pdata else 0

    bvals = [np.asarray(bdata[bc]) for _, bc in keys]
    bvalid = [~pd.isna(v) for v in bvals]
    uniques, comps, keep = HJ.build_key_components(bvals, bvalid)
    cards = [len(u) for u in uniques]
    if HJ.key_domain(cards) >= HJ.MAX_KEY_DOMAIN:
        raise JoinUnsupported("partition key domain exceeds int32")
    bsel = {c: np.asarray(v)[keep] for c, v in bdata.items()}
    fused_b = HJ.fuse_components(comps, cards)
    table = HJ.build_table(fused_b, int(spec.get("max_matches", 1 << 20)))
    width = max(1, table.max_count)

    pk, pvalid = _canon_probe_keys(uniques,
                                   [pdata[pc] for pc, _ in keys])
    if n_probe == 0 or table.n_build == 0:
        pi = np.zeros(0, dtype=np.int64)
        bi = np.zeros(0, dtype=np.int64)
    else:
        pi, bi = _match_pairs(table, pk, pvalid, width, device)

    def cell_env(qname: str) -> np.ndarray:
        side, phys = colside[qname]
        src = pdata if side == "probe" else bsel
        arr = np.asarray(src[phys])
        return arr[pi] if side == "probe" else arr[bi]

    env = {q: cell_env(q) for q in colside}
    if spec.get("residual") is not None:
        res = SERDE.expr_from_dict(spec["residual"])
        m = host_eval.eval_pred3(res, env)
        env = {q: v[m] for q, v in env.items()}

    n_pairs = len(next(iter(env.values()))) if env else \
        (len(pi) if spec.get("residual") is None else 0)
    frame_cols = {}
    for g in group_by:
        frame_cols[g] = env[g]
    df = pd.DataFrame(frame_cols) if frame_cols else \
        pd.DataFrame(index=range(n_pairs))

    def agg_vals(a) -> Optional[np.ndarray]:
        if a.get("arg") is None:
            return None
        e = SERDE.expr_from_dict(a["arg"])
        return np.asarray(host_eval.eval_expr(e, env))

    out_cols: List[str] = list(group_by)
    out: Dict[str, np.ndarray] = {}

    def obj(vals: list) -> np.ndarray:
        arr = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            arr[i] = v
        return arr

    if group_by:
        grouped = df.assign(__row__=np.arange(n_pairs)) \
            .groupby(group_by, dropna=False, sort=False)["__row__"] \
            .agg(list)
        gkeys = list(grouped.index)
        gidx = [np.asarray(v, dtype=np.int64) for v in grouped]
        if len(group_by) == 1:
            gkeys = [(k,) for k in gkeys]
    else:
        gkeys = [()]
        gidx = [np.arange(n_pairs, dtype=np.int64)]
    for ki, g in enumerate(group_by):
        out[g] = obj([None if pd.isna(k[ki]) else
                      (k[ki].item() if isinstance(k[ki], np.generic)
                       else k[ki]) for k in gkeys])
    for a in aggs:
        name = str(a["out"])
        fn = str(a["fn"])
        vals = agg_vals(a)
        cells, vcs = [], []
        for rows in gidx:
            if fn == "count":
                if vals is None:
                    cells.append(int(len(rows)))
                else:
                    cells.append(int((~pd.isna(vals[rows])).sum()))
                vcs.append(0)
                continue
            v = vals[rows]
            ok = ~pd.isna(v)
            nv = v[ok]
            vcs.append(int(len(nv)))
            if len(nv) == 0:
                cells.append(None)
            elif fn in ("sum", "avg"):
                cells.append(_sum_cell(nv))
            elif fn == "min":
                cells.append(nv.min().item())
            else:
                cells.append(nv.max().item())
        out[name] = obj(cells)
        out_cols.append(name)
        if fn == "avg":
            vc_name = "__vc__" + name
            out[vc_name] = np.asarray(vcs, dtype=np.int64)
            out_cols.append(vc_name)
    return out_cols, out


def exec_request(ctx, raw: bytes) -> bytes:
    """Hop 2 on a node: decode an SDJ1 exec frame, run the local join on
    the node context's device, return the partials as an SDW1 frame."""
    spec, sides = WIRE.decode_join_exec(raw)
    cols, data = local_join(spec, sides["probe"], sides["build"],
                            device=ctx.device)
    return WIRE.encode_result(cols, data, {"rows": int(
        len(data[cols[0]]) if cols else 0)})


# =============================================================================
# broker side
# =============================================================================

def _merge_kind(fn: str) -> str:
    return {"count": "longsum", "sum": "longsum", "avg": "longsum",
            "min": "longmin", "max": "longmax"}[fn]


def execute_partitioned(ctx, plan, spec: dict):
    """Run ``plan`` across the cluster. Returns ``(data, js)`` in the
    same shape the broadcast tier returns (the planner epilogue is
    shared). Raises :class:`JoinUnsupported` on any cluster failure —
    the caller falls back to the local broadcast tier. Beyond the JAX
    package's stats: ``split_ms`` (the broker regrouping hop-1 rows by
    partition) and ``merge_ms`` (the partials' merge and finalize), host
    wall clock."""
    from spark_druid_olap_tpu_torch.cluster import merge as MG
    cl = ctx.cluster
    if cl is None:
        raise JoinUnsupported("no cluster attached")
    st = cl._active
    n_nodes = len(st.nodes)
    n_parts = int(ctx.config.get(JOIN_PARTITIONS)) or n_nodes
    shuffle = 0
    scatters = 0
    deadline = time.time() + cl.rpc_timeout * 4

    from spark_druid_olap_tpu_torch.cluster.assign import shard_name

    def side_rows(side_key: str, side, flt, ship: List[str],
                  read: List[str]):
        dp = st.plan.datasources.get(side.ds)
        if dp is None:
            raise JoinUnsupported(
                f"datasource {side.ds!r} has no cluster plan")
        keys = [pc for pc, _ in plan.keys] if side_key == "probe" \
            else [bc for _, bc in plan.keys]
        frames = []
        nonlocal shuffle, scatters
        for sh in dp.shards:
            payload = json.dumps({
                "store": shard_name(side.ds, sh.index, dp.n_shards),
                "keys": keys, "ship": ship, "read": read,
                "filter": SERDE.expr_to_dict(flt)
                if flt is not None else None,
                "npartitions": n_parts,
            }, separators=(",", ":")).encode("utf-8")
            err = None
            for nid in sh.owners:
                try:
                    scatters += 1
                    status, resp = cl._guarded_rpc(
                        st, nid, payload, deadline,
                        path="/cluster/join/partition")
                except Exception as e:          # breaker open / IO
                    err = e
                    continue
                if status != 200:
                    err = JoinUnsupported(
                        f"partition rpc {status}: "
                        f"{WIRE.decode_error(resp).get('message')}")
                    continue
                shuffle += len(resp)
                try:
                    cols, data, _ = WIRE.decode_result(resp)
                except ValueError as e:
                    err = e
                    continue
                frames.append((cols, data))
                err = None
                break
            if err is not None:
                raise JoinUnsupported(
                    f"partition hop failed for {side.ds!r} shard "
                    f"{sh.index}: {err}")
        return frames

    probe_ship = sorted({phys for q, (s, phys) in plan.colside.items()
                         if s == "probe"}
                        | {pc for pc, _ in plan.keys})
    build_ship = sorted({phys for q, (s, phys) in plan.colside.items()
                         if s == "build"}
                        | {bc for _, bc in plan.keys})
    pframes = side_rows("probe", plan.probe, plan.probe_filter,
                        probe_ship, sorted(plan.probe_cols()))
    bframes = side_rows("build", plan.build, plan.build_filter,
                        build_ship, sorted(plan.build_cols()))

    def split(frames, cols: List[str]):
        parts = [{c: [] for c in cols} for _ in range(n_parts)]
        for fcols, data in frames:
            pid = np.asarray(data["__part__"], dtype=np.int64)
            for p in range(n_parts):
                m = pid == p
                if not m.any():
                    continue
                for c in cols:
                    parts[p][c].append(np.asarray(data[c])[m])
        out = []
        for p in range(n_parts):
            out.append({c: (np.concatenate(v) if v else
                            np.zeros(0, dtype=object))
                        for c, v in parts[p].items()})
        return out

    t_split = time.perf_counter()
    pparts = split(pframes, probe_ship)
    bparts = split(bframes, build_ship)
    split_ms = (time.perf_counter() - t_split) * 1e3

    partials = []
    for p in range(n_parts):
        nid = p % n_nodes
        payload = WIRE.encode_join_exec(
            spec, {"probe": (probe_ship, pparts[p]),
                   "build": (build_ship, bparts[p])})
        shuffle += len(payload)
        scatters += 1
        try:
            status, resp = cl._guarded_rpc(
                st, nid, payload, deadline, path="/cluster/join/exec")
        except Exception as e:
            raise JoinUnsupported(f"exec hop failed on node {nid}: {e}")
        if status != 200:
            raise JoinUnsupported(
                f"exec rpc {status} on node {nid}: "
                f"{WIRE.decode_error(resp).get('message')}")
        try:
            _, data, _ = WIRE.decode_result(resp)
        except ValueError as e:
            raise JoinUnsupported(f"exec hop bad frame: {e}")
        partials.append(data)

    t_merge = time.perf_counter()
    mg_aggs = []
    for s in plan.aggs:
        mg_aggs.append((s.out, _merge_kind(s.fn)))
        if s.fn == "avg":
            mg_aggs.append(("__vc__" + s.out, "longsum"))
    _, merged, n_rows = MG.merge_partials(partials, list(plan.group_by),
                                          mg_aggs)
    data: Dict[str, np.ndarray] = {}
    for g in plan.group_by:
        data[g] = merged[g]
    for s in plan.aggs:
        col = merged[s.out]
        if s.fn == "avg":
            vc = np.asarray(merged["__vc__" + s.out], dtype=np.float64)
            tot = np.asarray([np.nan if v is None else float(v)
                              for v in col.tolist()], dtype=np.float64) \
                if col.dtype == object else col.astype(np.float64)
            data[s.out] = np.where(vc > 0, tot / np.maximum(vc, 1),
                                   np.nan)
        elif s.fn == "count":
            data[s.out] = np.zeros(n_rows, dtype=np.int64) \
                if col.dtype == object and n_rows == 0 \
                else np.asarray([0 if v is None else v
                                 for v in col.tolist()],
                                dtype=np.int64) \
                if col.dtype == object else col.astype(np.int64)
        else:
            data[s.out] = col
    if not plan.group_by and n_rows == 0:
        for s in plan.aggs:
            data[s.out] = np.asarray(
                [0] if s.fn == "count" else [np.nan])
    merge_ms = (time.perf_counter() - t_merge) * 1e3
    with cl._lock:
        cl.counters["join_scatters"] += scatters
        cl.counters["join_shuffle_bytes"] += shuffle
    stats = {
        "mode": "partitioned",
        "partitions": int(n_parts),
        "nodes": int(n_nodes),
        "scatters": int(scatters),
        "build_rows": int(sum(len(next(iter(b.values()), []))
                              for b in bparts if b)),
        "groups": int(len(data[plan.group_by[0]]) if plan.group_by
                      else 1),
    }
    stats["shuffle_bytes"] = int(shuffle)
    stats["split_ms"] = split_ms
    stats["merge_ms"] = merge_ms
    return data, stats
