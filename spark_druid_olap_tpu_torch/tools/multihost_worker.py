"""One rank of the multi-process mesh, and the rig that starts N of them.

The port's counterpart of the JAX package's ``tests/multihost_worker.py``:
each rank is one "host" of ``parallel/multihost.py``. It joins the
``torch.distributed`` group, ingests only its host's segment rows (a
partial store), runs a statement set and writes its answers as JSON. The
tests, ``chip_smoke.py`` and ``scripts/torch_multihost_probe.py`` share
it::

    python -m spark_druid_olap_tpu_torch.tools.multihost_worker \\
        <rank> <world> <port> <out> <mode> <device> <backend>

- ``out``: the rank writes ``<out>.rank<rank>.json``.
- ``mode``: ``probe`` (one collective), ``basic`` (the sales frame and
  its statement set, :func:`run_basic`), ``threads`` (that frame's
  statements all at once from threads, submitted in an order of the
  rank's own, :func:`run_threads`), ``census`` (TPC-H 22 + SSB 13 over
  SF 0.02 partial flat stores, :func:`run_census`) or
  ``call=<module>:<function>[:<argument>]``, which runs
  ``function(rank, world, slots, argument)`` and writes what it returns.
- ``device``: ``cpu``, ``cuda`` or ``cuda:N``, or a comma list (the
  rank's mesh slots); ``a;b`` gives rank 0 ``a``, rank 1 ``b`` and so on.
- ``backend``: ``gloo`` or ``nccl`` (``multihost.initialize``; nothing
  falls back).

:func:`spawn` starts the ranks as subprocesses (never a fork of the
caller), with a wall timeout; on its way out it kills every rank still
running. Every group has a collective timeout (``TIMEOUT_S``), so a
mismatch fails in seconds instead of hanging.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

TIMEOUT_S = 120.0


def make_frame():
    """The JAX worker's seeded sales frame (60,000 rows)."""
    import numpy as np
    import pandas as pd
    rng = np.random.default_rng(42)
    n = 60_000
    return pd.DataFrame({
        "ts": pd.Timestamp("2021-01-01")
        + pd.to_timedelta(rng.integers(0, 365, n), unit="D"),
        "region": rng.choice(["east", "west", "north", "south"], n),
        "sku": rng.integers(0, 2000, n).astype(str),     # high-card dim
        "qty": rng.integers(0, 50, n),
        "price": rng.normal(20.0, 5.0, n).round(3),
        "wide": rng.integers(-1_000_000, 1_000_000, n),
    })


# the JAX worker's QUERIES, statement for statement
QUERIES = {
    "dense": ("select region, sum(qty) as q, count(*) as c, "
              "min(price) as mn, max(price) as mx from sales "
              "where qty > 10 group by region order by region"),
    "hashed": ("select sku, sum(qty) as q from sales "
               "where qty > 30 group by sku order by q desc, sku limit 25"),
    "timeseries": ("select date_trunc('month', ts) as m, sum(price) as p, "
                   "count(*) as c from sales group by 1 order by 1"),
    "having": ("select region, avg(price) as ap from sales group by region "
               "having count(*) > 100 order by region"),
    "pruned": ("select region, count(*) as c from sales "
               "where ts >= timestamp '2021-10-01' group by region "
               "order by region"),
    "hll": ("select approx_count_distinct(sku) as d from sales"),
}

# what the basic set adds: forced waves (dense and hashed), a statement the
# host tier answers by gathering the partial store, and a storm of 4
WAVED = {
    "dense": ("select region, sum(qty) as q, count(*) as c from sales "
              "group by region order by region"),
    "hashed": ("select sku, sum(qty) as q from sales group by sku "
               "order by q desc, sku limit 20"),
}
# a 2-argument session function has no device lowering: the statement
# runs whole on the host tier, which must gather the partial store
HOST_GATHER = ("select region, count(*) as n from sales "
               "where hostfn(qty, price) > 60 group by region "
               "order by region")
STORM = [
    "select region, sum(qty) as q from sales group by region "
    "order by region",
    "select region, count(*) as c from sales where qty > 25 "
    "group by region order by region",
    "select region, max(price) as mx from sales group by region "
    "order by region",
    "select region, sum(wide) as w from sales where price > 20 "
    "group by region order by region",
]
WAVE_MAX_BYTES = 1 << 14


def digest(r) -> str:
    """A hash of an answer frame's bytes: two ranks' answers are byte for
    byte the same when their digests are."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for c in r.columns:
        v = r[c].to_numpy()
        h.update(c.encode())
        h.update(repr(v.tolist()).encode() if v.dtype == object
                 else np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def answer(ctx, sql) -> dict:
    """One statement's answer, its host wall ms and the stats the
    comparison reads."""
    t0 = time.perf_counter()
    r = ctx.sql(sql).to_pandas()
    ms = (time.perf_counter() - t0) * 1e3
    st = ctx.history.entries()[-1].stats
    return {**frame_answer(r), "ms": ms,
            "mode": st.get("mode", "engine"),
            "sharded": bool(st.get("sharded")),
            "waves": int(st.get("waves", 1)),
            "hash_slots": st.get("hash_slots"),
            "hash_compact_k": st.get("hash_compact_k"),
            "topk_exchange": bool(st.get("topk_exchange")),
            "multihost": st.get("multihost")}


def frame_answer(r) -> dict:
    return {"columns": list(r.columns),
            "rows": json.loads(r.to_json(orient="values",
                                         date_format="iso",
                                         double_precision=15)),
            "digest": digest(r)}


def run_queries(ctx, queries) -> dict:
    return {name: answer(ctx, sql) for name, sql in queries.items()}


WAVE_KEY = "sdot.engine.wave.max.bytes"


def run_basic(ctx, S=None) -> dict:
    """The JAX worker's six statements, then forced waves, a select page,
    a search, the host tier's gather and a storm of four (declined by the
    coalescer: each runs solo over the mesh). ``S`` is the ``ir.spec``
    module of the context's package (the port's by default), so the same
    set runs on a JAX context too."""
    from concurrent.futures import ThreadPoolExecutor
    if S is None:
        from spark_druid_olap_tpu_torch.ir import spec as S
    out = run_queries(ctx, QUERIES)
    prev = ctx.config.get(WAVE_KEY)
    ctx.config.set(WAVE_KEY, WAVE_MAX_BYTES)
    try:
        out.update({f"waved_{n}": answer(ctx, sql)
                    for n, sql in WAVED.items()})
    finally:
        ctx.config.set(WAVE_KEY, prev)
    sel = ctx.execute(S.SelectQuerySpec(
        datasource="sales", columns=("ts", "region", "sku", "qty", "price"),
        filter=S.BoundFilter("qty", lower=45.0, numeric=True),
        page_offset=7, page_size=40))
    out["select_page"] = {**frame_answer(sel.to_pandas()), "mode": "select",
                          "select_filter": ctx.engine.last_stats.get(
                              "select_filter")}
    srch = ctx.execute(S.SearchQuerySpec(
        datasource="sales", dimensions=("region", "sku"), query="1"))
    out["search"] = {**frame_answer(srch.to_pandas()), "mode": "search"}
    ctx.functions["hostfn"] = lambda a, b: float(a) + float(b)
    out["host_gather"] = answer(ctx, HOST_GATHER)
    ctx.config.set("sdot.sharedscan.enabled", True)
    try:
        before = ctx.engine.sharedscan.stats()
        with ThreadPoolExecutor(len(STORM)) as pool:
            frames = list(pool.map(lambda s: ctx.sql(s).to_pandas(), STORM))
        after = ctx.engine.sharedscan.stats()
    finally:
        ctx.config.set("sdot.sharedscan.enabled", False)
    out["storm"] = {"answers": [frame_answer(f) for f in frames],
                    "coalesced": after["queries_coalesced"]
                    - before["queries_coalesced"]}
    return out


def run_threads(ctx, rank: int) -> dict:
    """Every statement of ``QUERIES`` and ``STORM`` at once, one thread
    each, submitted in an order seeded by the rank (so the ranks submit
    differently) with a short switch interval: the statements must take
    their turns in an order the ranks agree on
    (``multihost.SEQUENCER``), or their collectives would mismatch."""
    import random
    from concurrent.futures import ThreadPoolExecutor
    sqls = {**QUERIES, **{f"storm{i}": q for i, q in enumerate(STORM)}}
    names = sorted(sqls)
    random.Random(rank).shuffle(names)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            futs = {n: pool.submit(lambda q: ctx.sql(q).to_pandas(),
                                   sqls[n]) for n in names}
            out = {n: frame_answer(f.result()) for n, f in futs.items()}
    finally:
        sys.setswitchinterval(interval)
    out["_order"] = names
    return out


CENSUS_SF = 0.02
CENSUS_DROP = ["l_comment", "o_comment", "c_comment", "s_comment",
               "ps_comment", "cn_comment", "cr_comment", "sn_comment",
               "sr_comment", "c_address", "s_address", "o_clerk"]


def census_contexts(world: int, rank: int, device, mesh):
    """The JAX worker's census stores: TPC-H with the flat indexes partial
    (``n_hosts`` / ``host_id``) and the base tables whole, and SSB in a
    context of its own; ``world`` 1 builds the complete stores."""
    import pandas as pd

    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.tools import ssb, tpch
    part = {"n_hosts": world, "host_id": rank} if world > 1 else {}
    conf = {"sdot.cache.enabled": False}
    ctx = sdt.Context(conf, device=device, mesh=mesh)
    tables = tpch.generate(CENSUS_SF)
    flat = tpch.flatten(tables)
    flat = flat.drop(columns=[c for c in CENSUS_DROP if c in flat.columns])
    ctx.ingest_dataframe("tpch_flat", flat, time_column="l_shipdate",
                         target_rows=1 << 12, **part)
    for name, df in tables.items():
        if name in ("nation", "region"):
            continue
        tcol = {"lineitem": "l_shipdate", "orders": "o_orderdate"}.get(name)
        ctx.ingest_dataframe(name, df, time_column=tcol,
                             target_rows=1 << 14)
    for name, df in tpch.nation_region_views(tables).items():
        ctx.ingest_dataframe(name, df)
    ctx.ingest_dataframe("partsupp_flat", tpch.flatten_partsupp(tables),
                         target_rows=1 << 12, **part)
    ctx.register_star_schema(tpch.partsupp_star_schema("partsupp_flat"))
    ctx.register_star_schema(tpch.star_schema("tpch_flat"))
    ctx.ingest_dataframe("segdim", pd.DataFrame({
        "seg_name": ["AUTOMOBILE", "BUILDING", "FURNITURE"],
        "min_q": [10, 20, 30]}))
    ctx.functions["hostfn"] = lambda a, b: float(a) * 2 + float(b)
    cssb = sdt.Context(conf, device=device, mesh=mesh)
    stables = ssb.generate(CENSUS_SF)
    cssb.ingest_dataframe("ssb_flat", ssb.flatten(stables),
                          time_column="lo_orderdate", target_rows=1 << 12,
                          **part)
    for name, df in stables.items():
        cssb.ingest_dataframe(name, df, time_column={
            "lineorder": "lo_orderdate"}.get(name), target_rows=1 << 14)
    cssb.register_star_schema(ssb.star_schema("ssb_flat"))
    return ctx, cssb


def run_census(ctx, cssb) -> dict:
    """The JAX worker's ``run_census``: TPC-H 22 and SSB 13, the
    decorrelated and host-gather statements, forced waves, a select page
    and a search over the partial flat store."""
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.tools import ssb, tpch
    out = {f"tpch_{n}": v for n, v in run_queries(ctx, tpch.QUERIES).items()}
    out.update({f"ssb_{n}": v
                for n, v in run_queries(cssb, ssb.QUERIES).items()})
    out.update(run_queries(ctx, {
        "decorrelated": (
            "select seg_name from segdim where "
            "(select count(*) from tpch_flat where c_mktsegment = seg_name"
            " and l_quantity >= min_q) > 100 order by seg_name"),
        "host_gather": (
            "select l_returnflag, count(*) as n from tpch_flat "
            "where hostfn(l_quantity, l_discount) > 25 "
            "group by l_returnflag order by l_returnflag")}))
    prev = ctx.config.get(WAVE_KEY)
    ctx.config.set(WAVE_KEY, WAVE_MAX_BYTES)
    try:
        out.update({f"waved_{n}": v for n, v in run_queries(ctx, {
            "dense": ("select l_returnflag, sum(l_quantity) as q, "
                      "count(*) as c from tpch_flat group by l_returnflag "
                      "order by l_returnflag"),
            "hashed": ("select l_orderkey, sum(l_quantity) as q from "
                       "tpch_flat group by l_orderkey "
                       "order by q desc, l_orderkey limit 20")}).items()})
    finally:
        ctx.config.set(WAVE_KEY, prev)
    sel = ctx.execute(S.SelectQuerySpec(
        datasource="tpch_flat",
        columns=("l_orderkey", "l_quantity", "l_shipmode", "c_mktsegment"),
        filter=S.BoundFilter("l_quantity", lower=45.0, numeric=True),
        page_offset=7, page_size=40)).to_pandas()
    out["select_page"] = {**frame_answer(sel), "mode": "select"}
    srch = ctx.execute(S.SearchQuerySpec(
        datasource="tpch_flat", dimensions=("l_shipmode", "c_mktsegment"),
        query="AI")).to_pandas()
    out["search"] = {**frame_answer(srch), "mode": "search"}
    return out


def explain_alone(ctx) -> dict:
    """EXPLAIN of a sharded statement over the partial store, on one rank
    alone and before any statement: planning must issue no collective
    (the other ranks would not join it). Returns the plan's text and the
    collectives it issued."""
    from spark_druid_olap_tpu_torch.parallel import multihost as MH
    n0 = MH.stats_snapshot()["collectives"]
    plan = ctx.sql("EXPLAIN " + QUERIES["dense"]).to_pandas()
    return {"text": "\n".join(map(str, plan.iloc[:, 0])),
            "collectives": MH.stats_snapshot()["collectives"] - n0}


def slots_of(device: str, rank: int) -> List[str]:
    """This rank's mesh slots from the ``device`` argument."""
    per_rank = device.split(";")
    spec = per_rank[rank] if len(per_rank) > 1 else per_rank[0]
    return [d.strip() for d in spec.split(",") if d.strip()]


def context_args(slots):
    """``(device, mesh)`` of a Context over ``slots``."""
    import torch
    if len(slots) > 1:
        return None, tuple(torch.device(d) for d in slots)
    return slots[0], None


def run_rank(rank: int, world: int, port: int, out: str, mode: str,
             device: str, backend: str) -> dict:
    import torch

    from spark_druid_olap_tpu_torch.parallel import multihost as MH
    slots = slots_of(device, rank)
    first = torch.device(slots[0])
    if first.type == "cuda":
        torch.cuda.set_device(first.index or 0)
    MH.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend,
                  timeout=TIMEOUT_S,
                  devices=[d for d in slots if d.startswith("cuda")],
                  slots=len(slots))
    try:
        t0 = time.perf_counter()
        if mode == "probe":
            got = MH.gather_partials(
                {"r": torch.tensor([rank], device=first)})
            result = {"ranks": [int(g["r"][0]) for g in got]}
        elif mode == "basic":
            import spark_druid_olap_tpu_torch as sdt
            dev, mesh = context_args(slots)
            ctx = sdt.Context({"sdot.cache.enabled": False}, device=dev,
                              mesh=mesh)
            ds = ctx.ingest_dataframe("sales", make_frame(), time_column="ts",
                                      target_rows=4096, n_hosts=world,
                                      host_id=rank)
            result = {"explain": explain_alone(ctx)} if rank == 0 else {}
            result.update(run_basic(ctx))
            result["_store"] = store_meta(ds)
        elif mode == "threads":
            import spark_druid_olap_tpu_torch as sdt
            dev, mesh = context_args(slots)
            ctx = sdt.Context({"sdot.cache.enabled": False}, device=dev,
                              mesh=mesh)
            ctx.ingest_dataframe("sales", make_frame(), time_column="ts",
                                 target_rows=4096, n_hosts=world,
                                 host_id=rank)
            result = run_threads(ctx, rank)
        elif mode == "census":
            dev, mesh = context_args(slots)
            ctx, cssb = census_contexts(world, rank, dev, mesh)
            result = run_census(ctx, cssb)
            result["_store"] = store_meta(ctx.store.get("tpch_flat"))
        elif mode.startswith("call="):
            mod, fn, *arg = mode[len("call="):].split(":", 2)
            result = getattr(importlib.import_module(mod), fn)(
                rank, world, slots, arg[0] if arg else None)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        result["_meta"] = {"rank": rank, "world": world, "slots": slots,
                           "backend": backend,
                           "seconds": time.perf_counter() - t0,
                           "collectives": MH.stats_snapshot()}
    finally:
        MH.shutdown()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def store_meta(ds) -> dict:
    """What a rank holds of a partial store."""
    return {"partial": bool(ds.is_partial),
            "local_segments": int(len(ds.local_seg_ids))
            if ds.is_partial else int(ds.num_segments),
            "segments": int(ds.num_segments),
            "local_rows": int(ds.local_num_rows),
            "rows": int(ds.num_rows),
            "column_rows": {c: int(len(m.values))
                            for c, m in ds.metrics.items()}}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(world: int, out: str, mode: str, *, device: str,
          backend: str = "gloo", timeout_s: float = 600.0,
          cwd: Optional[str] = None) -> List[dict]:
    """Run ``world`` ranks to completion and return their results in rank
    order. ``device`` has no default: the caller names where the ranks run
    (``cpu``, ``cuda``, ``cuda:N`` or the slot lists of ``slots_of``).
    Raises ``RuntimeError`` with every rank's log when a rank fails
    or the wall timeout passes. Every rank still running on the way out is
    killed."""
    port = free_port()
    e = dict(os.environ)
    e.setdefault("OMP_NUM_THREADS", "2")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    e["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in e.get("PYTHONPATH", "").split(os.pathsep) if p])
    # each rank logs to a file: a pipe nobody drains could block a rank,
    # and the others with it at their next collective
    logs = [open(f"{out}.rank{r}.log", "wb") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spark_druid_olap_tpu_torch.tools."
         "multihost_worker", str(r), str(world), str(port), out, mode,
         device, backend], env=e, cwd=cwd or here,
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = []
        for r in range(world):
            with open(f"{out}.rank{r}.log", errors="replace") as f:
                text.append(f"[rank {r}]\n{f.read()[-6000:]}")
        raise RuntimeError(f"multihost ranks {failed} failed (wall limit "
                           f"{timeout_s} s):\n" + "\n====\n".join(text))
    out_rs = []
    for r in range(world):
        with open(f"{out}.rank{r}.json") as f:
            out_rs.append(json.load(f))
    return out_rs


def main(argv) -> int:
    if len(argv) != 7:
        print(__doc__, file=sys.stderr)
        return 2
    rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
    run_rank(rank, world, port, argv[3], argv[4], argv[5], argv[6])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
