"""TPC-H data generation, flattening, and star-schema wiring.

Port of ``spark_druid_olap_tpu/tools/tpch.py``, copied so the port and
``chip_smoke.py`` need nothing of the JAX package: ``generate`` gives the
same eight tables for the same seed, value for value (lineitem's draws
follow the other tables' in one random stream, so the whole generator is
kept); ``flatten`` / ``flatten_partsupp`` denormalize them onto the
lineitem and partsupp grains; ``star_schema`` / ``partsupp_star_schema``
declare the stars that joins collapse onto; ``setup_context`` ingests it
all; ``QUERIES`` are the benchmark statements; ``flatten_stream`` is the
out-of-core flatten over the port's streaming ingest
(``segment/stream_ingest.flatten_join_stream``).

The generator is a fast, deterministic, schema-faithful approximation of
dbgen (uniform draws over real TPC-H value domains); answers are checked
differentially against an oracle on the same frame, so exact dbgen
distributions are unnecessary.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.metadata.star import StarRelation, StarSchema

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                  "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]


def generate(sf: float = 0.01, seed: int = 20260729) -> Dict[str, pd.DataFrame]:
    """Generate all eight TPC-H tables at scale factor ``sf``."""
    r = np.random.default_rng(seed)
    n_orders = max(10, int(1_500_000 * sf))
    n_cust = max(5, int(150_000 * sf))
    n_part = max(5, int(200_000 * sf))
    n_supp = max(3, int(10_000 * sf))

    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS,
        "r_comment": [f"region {i}" for i in range(5)]})

    nation = pd.DataFrame({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.array([k for _, k in NATIONS], dtype=np.int64),
        "n_comment": [f"nation {i}" for i in range(25)]})

    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
        "s_address": [f"addr{i}" for i in range(n_supp)],
        "s_nationkey": r.integers(0, 25, n_supp),
        "s_phone": [f"{r.integers(10,35)}-{i:07d}" for i in range(n_supp)],
        "s_acctbal": np.round(r.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": [("Customer Complaints" if r.random() < 0.005
                       else f"supplier comment {i}") for i in range(n_supp)]})

    customer = pd.DataFrame({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
        "c_address": [f"caddr{i}" for i in range(n_cust)],
        "c_nationkey": r.integers(0, 25, n_cust),
        "c_phone": [f"{10 + i % 25}-{i:07d}" for i in range(n_cust)],
        "c_acctbal": np.round(r.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": r.choice(SEGMENTS, n_cust),
        "c_comment": [f"customer comment {i}" for i in range(n_cust)]})

    part = pd.DataFrame({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": [f"part {i} "
                   + " ".join(r.choice(["green", "blue", "red", "ivory",
                                        "magenta", "plum", "puff", "powder",
                                        "forest", "lace"],
                                       3))
                   for i in range(1, n_part + 1)],
        "p_mfgr": [f"Manufacturer#{1 + i % 5}" for i in range(n_part)],
        "p_brand": [f"Brand#{1 + (i % 5)}{1 + (i // 5) % 5}"
                    for i in range(n_part)],
        "p_type": r.choice(TYPES, n_part),
        "p_size": r.integers(1, 51, n_part),
        "p_container": r.choice(CONTAINERS, n_part),
        "p_retailprice": np.round(900 + (np.arange(1, n_part + 1) % 1000)
                                  / 10.0, 2),
        "p_comment": [f"part comment {i}" for i in range(n_part)]})

    # partsupp: 4 suppliers per part
    ps_part = np.repeat(part.p_partkey.to_numpy(), 4)
    ps_supp = ((ps_part + np.tile(np.arange(4), n_part)
                * (n_supp // 4 + 1)) % n_supp) + 1
    partsupp = pd.DataFrame({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp.astype(np.int64),
        "ps_availqty": r.integers(1, 10000, len(ps_part)),
        "ps_supplycost": np.round(r.uniform(1.0, 1000.0, len(ps_part)), 2),
        "ps_comment": [f"ps comment {i}" for i in range(len(ps_part))]})

    start = np.datetime64("1992-01-01")
    o_dates = start + r.integers(0, 2406, n_orders).astype("timedelta64[D]")
    orders = pd.DataFrame({
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": r.integers(1, n_cust + 1, n_orders),
        "o_orderstatus": r.choice(["O", "F", "P"], n_orders,
                                  p=[0.49, 0.49, 0.02]),
        "o_totalprice": np.round(r.uniform(800, 500000, n_orders), 2),
        "o_orderdate": o_dates.astype("datetime64[ns]"),
        "o_orderpriority": r.choice(PRIORITIES, n_orders),
        "o_clerk": [f"Clerk#{1 + i % 1000:09d}" for i in range(n_orders)],
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
        "o_comment": [("special requests" if r.random() < 0.01
                       else f"order comment {i}") for i in range(n_orders)]})

    # lineitem: 1-7 lines per order (avg 4)
    lines_per = r.integers(1, 8, n_orders)
    li_order = np.repeat(orders.o_orderkey.to_numpy(), lines_per)
    n_li = len(li_order)
    li_odate = np.repeat(o_dates, lines_per)
    ship_delay = r.integers(1, 122, n_li).astype("timedelta64[D]")
    l_ship = li_odate + ship_delay
    l_commit = li_odate + r.integers(30, 91, n_li).astype("timedelta64[D]")
    l_receipt = l_ship + r.integers(1, 31, n_li).astype("timedelta64[D]")
    l_part = r.integers(1, n_part + 1, n_li)
    # supplier consistent with partsupp: one of the 4 for the part
    l_supp = ((l_part + r.integers(0, 4, n_li) * (n_supp // 4 + 1))
              % n_supp) + 1
    qty = r.integers(1, 51, n_li).astype(np.int64)
    extprice = np.round(qty * (900 + (l_part % 1000) / 10.0), 2)
    # returnflag: R/A only for ship dates in the past relative to 1995-06-17
    cutoff = np.datetime64("1995-06-17")
    rf = np.where(l_receipt <= cutoff,
                  r.choice(["R", "A"], n_li), "N")
    ls = np.where(l_ship > np.datetime64("1995-06-17"), "O", "F")
    lineitem = pd.DataFrame({
        "l_orderkey": li_order,
        "l_partkey": l_part.astype(np.int64),
        "l_suppkey": l_supp.astype(np.int64),
        "l_linenumber": np.concatenate(
            [np.arange(1, k + 1) for k in lines_per]).astype(np.int64),
        "l_quantity": qty,
        "l_extendedprice": extprice,
        "l_discount": np.round(r.integers(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(r.integers(0, 9, n_li) / 100.0, 2),
        "l_returnflag": rf,
        "l_linestatus": ls,
        "l_shipdate": l_ship.astype("datetime64[ns]"),
        "l_commitdate": l_commit.astype("datetime64[ns]"),
        "l_receiptdate": l_receipt.astype("datetime64[ns]"),
        "l_shipinstruct": r.choice(INSTRUCTS, n_li),
        "l_shipmode": r.choice(SHIPMODES, n_li),
        "l_comment": [f"line comment {i}" for i in range(n_li)]})

    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


def nation_region_views(tables) -> Dict[str, pd.DataFrame]:
    """The doubled nation/region dims for the customer and supplier join
    paths, with globally-unique column names (≈ the reference's
    custnation/custregion/suppnation/suppregion tables in
    StarSchemaBaseTest)."""
    nation, region = tables["nation"], tables["region"]
    cn = nation.rename(columns={
        "n_nationkey": "cn_nationkey", "n_name": "cn_name",
        "n_regionkey": "cn_regionkey", "n_comment": "cn_comment"})
    cr = region.rename(columns={
        "r_regionkey": "cr_regionkey", "r_name": "cr_name",
        "r_comment": "cr_comment"})
    sn = nation.rename(columns={
        "n_nationkey": "sn_nationkey", "n_name": "sn_name",
        "n_regionkey": "sn_regionkey", "n_comment": "sn_comment"})
    sr = region.rename(columns={
        "r_regionkey": "sr_regionkey", "r_name": "sr_name",
        "r_comment": "sr_comment"})
    return {"custnation": cn, "custregion": cr, "suppnation": sn,
            "suppregion": sr}


def flatten(tables) -> pd.DataFrame:
    """Denormalize the full star onto lineitem (≈ the reference's flattened
    52-column BI table indexed into Druid)."""
    nr = nation_region_views(tables)
    df = tables["lineitem"].merge(tables["orders"], left_on="l_orderkey",
                                  right_on="o_orderkey")
    df = df.merge(tables["customer"], left_on="o_custkey",
                  right_on="c_custkey")
    df = df.merge(nr["custnation"], left_on="c_nationkey",
                  right_on="cn_nationkey")
    df = df.merge(nr["custregion"], left_on="cn_regionkey",
                  right_on="cr_regionkey")
    df = df.merge(tables["part"], left_on="l_partkey", right_on="p_partkey")
    df = df.merge(tables["supplier"], left_on="l_suppkey",
                  right_on="s_suppkey")
    df = df.merge(nr["suppnation"], left_on="s_nationkey",
                  right_on="sn_nationkey")
    df = df.merge(nr["suppregion"], left_on="sn_regionkey",
                  right_on="sr_regionkey")
    df = df.merge(tables["partsupp"],
                  left_on=["l_partkey", "l_suppkey"],
                  right_on=["ps_partkey", "ps_suppkey"])
    return df.reset_index(drop=True)


def flatten_stream(tables, lineitem_path: str, out_path: str,
                   batch_rows: int = 1 << 20,
                   drop_columns=None) -> int:
    """Out-of-core flatten: stream lineitem from Parquet and denormalize
    chunk-by-chunk against the (smaller) dimension tables, writing the flat
    index to Parquet incrementally — the full flat frame never
    materializes (the pandas peak at SF>=10 would be several times the
    ~25GB+ flat size). Returns rows written."""
    from spark_druid_olap_tpu_torch.segment.stream_ingest import (
        flatten_join_stream)
    nr = nation_region_views(tables)
    joins = [
        (tables["orders"], "l_orderkey", "o_orderkey"),
        (tables["customer"], "o_custkey", "c_custkey"),
        (nr["custnation"], "c_nationkey", "cn_nationkey"),
        (nr["custregion"], "cn_regionkey", "cr_regionkey"),
        (tables["part"], "l_partkey", "p_partkey"),
        (tables["supplier"], "l_suppkey", "s_suppkey"),
        (nr["suppnation"], "s_nationkey", "sn_nationkey"),
        (nr["suppregion"], "sn_regionkey", "sr_regionkey"),
        (tables["partsupp"], ["l_partkey", "l_suppkey"],
         ["ps_partkey", "ps_suppkey"]),
    ]
    return flatten_join_stream(lineitem_path, out_path, joins,
                               batch_rows=batch_rows,
                               drop_columns=drop_columns)


def flatten_partsupp(tables) -> pd.DataFrame:
    """Denormalize the partsupp-grain star (partsupp x part x supplier x
    supp-nation/region). TPC-H q2/q11/q16/q20 aggregate at partsupp grain,
    where folding onto the lineitem flat index would multiply rows; Druid
    deployments likewise index one datasource per fact grain."""
    nr = nation_region_views(tables)
    df = tables["partsupp"].merge(tables["part"], left_on="ps_partkey",
                                  right_on="p_partkey")
    df = df.merge(tables["supplier"], left_on="ps_suppkey",
                  right_on="s_suppkey")
    df = df.merge(nr["suppnation"], left_on="s_nationkey",
                  right_on="sn_nationkey")
    df = df.merge(nr["suppregion"], left_on="sn_regionkey",
                  right_on="sr_regionkey")
    return df.reset_index(drop=True)


def partsupp_star_schema(
        flat_datasource: str = "partsupp_flat") -> StarSchema:
    """Second star: partsupp fact with part/supplier/nation/region dims."""
    return StarSchema("partsupp", flat_datasource, [
        StarRelation("partsupp", "part", (("ps_partkey", "p_partkey"),)),
        StarRelation("partsupp", "supplier",
                     (("ps_suppkey", "s_suppkey"),)),
        StarRelation("supplier", "suppnation",
                     (("s_nationkey", "sn_nationkey"),)),
        StarRelation("suppnation", "suppregion",
                     (("sn_regionkey", "sr_regionkey"),)),
    ])


def star_schema(flat_datasource: str = "tpch_flat") -> StarSchema:
    """The TPC-H star graph (≈ StarSchemaBaseTest's starSchema json)."""
    return StarSchema("lineitem", flat_datasource, [
        StarRelation("lineitem", "orders",
                     (("l_orderkey", "o_orderkey"),)),
        StarRelation("orders", "customer", (("o_custkey", "c_custkey"),)),
        StarRelation("customer", "custnation",
                     (("c_nationkey", "cn_nationkey"),)),
        StarRelation("custnation", "custregion",
                     (("cn_regionkey", "cr_regionkey"),)),
        StarRelation("lineitem", "part", (("l_partkey", "p_partkey"),)),
        StarRelation("lineitem", "supplier", (("l_suppkey", "s_suppkey"),)),
        StarRelation("supplier", "suppnation",
                     (("s_nationkey", "sn_nationkey"),)),
        StarRelation("suppnation", "suppregion",
                     (("sn_regionkey", "sr_regionkey"),)),
        StarRelation("lineitem", "partsupp",
                     (("l_partkey", "ps_partkey"),
                      ("l_suppkey", "ps_suppkey"))),
    ])


def setup_context(ctx, sf: float = 0.01, seed: int = 20260729,
                  target_rows: int = 1 << 20, flat_only: bool = False):
    """Ingest the TPC-H star into a Context: every base table as its own
    datasource (host-fallback/joins) plus the flat index, and register the
    star schema so star joins collapse onto it."""
    tables = generate(sf, seed)
    flat = flatten(tables)
    ctx.ingest_dataframe("tpch_flat", flat, time_column="l_shipdate",
                         target_rows=target_rows)
    if not flat_only:
        for name, df in tables.items():
            if name in ("nation", "region"):
                continue
            tcol = {"lineitem": "l_shipdate", "orders": "o_orderdate"}.get(name)
            ctx.ingest_dataframe(name, df, time_column=tcol,
                                 target_rows=target_rows)
        for name, df in nation_region_views(tables).items():
            ctx.ingest_dataframe(name, df, target_rows=target_rows)
        ctx.ingest_dataframe("partsupp_flat", flatten_partsupp(tables),
                             target_rows=target_rows)
        ctx.register_star_schema(partsupp_star_schema("partsupp_flat"))
    ctx.register_star_schema(star_schema("tpch_flat"))
    return tables, flat


# -- benchmark queries (altered TPC-H, reference BenchMarkDetails.org:69-78) --

QUERIES: Dict[str, str] = {
    # reference "Basic Aggregation"
    "basic_agg": """
        select l_returnflag, l_linestatus, count(*) as count_order,
               sum(l_extendedprice) as s, max(ps_supplycost) as m,
               avg(ps_availqty) as a, count(distinct o_orderkey) as od
        from lineitem li join orders o on li.l_orderkey = o.o_orderkey
             join partsupp ps on li.l_partkey = ps.ps_partkey
                  and li.l_suppkey = ps.ps_suppkey
        group by l_returnflag, l_linestatus
    """,
    # reference "Ship Date Range"
    "shipdate_range": """
        select l_returnflag, l_linestatus, count(*) as count_order
        from lineitem
        where l_shipdate >= date '1994-01-01' and l_shipdate <= date '1997-01-01'
        group by l_returnflag, l_linestatus
    """,
    # reference "SubQry + filters + ShpDt Range" (flattened form)
    "filters_range": """
        select s_nation, count(*) as count_order
        from (select l_returnflag, l_linestatus, sn_name as s_nation,
                     l_shipdate
              from lineitem li join supplier s on li.l_suppkey = s.s_suppkey
                   join suppnation sn on s.s_nationkey = sn.sn_nationkey) t
        where l_returnflag = 'R'
              and l_shipdate >= date '1994-01-01'
              and l_shipdate <= date '1995-01-01'
        group by s_nation
    """,
    "q1": """
        select l_returnflag, l_linestatus,
               sum(l_quantity) as sum_qty,
               sum(l_extendedprice) as sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
               avg(l_quantity) as avg_qty,
               avg(l_extendedprice) as avg_price,
               avg(l_discount) as avg_disc,
               count(*) as count_order
        from lineitem
        where l_shipdate <= date '1998-12-01' - interval '90' day
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus
    """,
    "q3": """
        select o_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
               o_orderdate, o_shippriority
        from customer c join orders o on c.c_custkey = o.o_custkey
             join lineitem l on l.l_orderkey = o.o_orderkey
        where c_mktsegment = 'BUILDING'
              and o_orderdate < date '1995-03-15'
              and l_shipdate > date '1995-03-15'
        group by o_orderkey, o_orderdate, o_shippriority
        order by revenue desc, o_orderdate
        limit 10
    """,
    "q5": """
        select sn_name, sum(l_extendedprice * (1 - l_discount)) as revenue
        from customer c join orders o on c.c_custkey = o.o_custkey
             join lineitem l on l.l_orderkey = o.o_orderkey
             join supplier s on l.l_suppkey = s.s_suppkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
             join suppregion r on n.sn_regionkey = r.sr_regionkey
        where sr_name = 'ASIA'
              and o_orderdate >= date '1994-01-01'
              and o_orderdate < date '1995-01-01'
        group by sn_name
        order by revenue desc
    """,
    "q6": """
        select sum(l_extendedprice * l_discount) as revenue
        from lineitem
        where l_shipdate >= date '1994-01-01'
              and l_shipdate < date '1995-01-01'
              and l_discount between 0.05 and 0.07
              and l_quantity < 24
    """,
    "q7": """
        select sn_name, cn_name, year(l_shipdate) as l_year,
               sum(l_extendedprice * (1 - l_discount)) as revenue
        from supplier s join lineitem l on s.s_suppkey = l.l_suppkey
             join orders o on o.o_orderkey = l.l_orderkey
             join customer c on c.c_custkey = o.o_custkey
             join suppnation n1 on s.s_nationkey = n1.sn_nationkey
             join custnation n2 on c.c_nationkey = n2.cn_nationkey
        where ((sn_name = 'FRANCE' and cn_name = 'GERMANY')
               or (sn_name = 'GERMANY' and cn_name = 'FRANCE'))
              and l_shipdate between date '1995-01-01' and date '1996-12-31'
        group by sn_name, cn_name, year(l_shipdate)
        order by sn_name, cn_name, l_year
    """,
    "q8": """
        select year(o_orderdate) as o_year,
               sum(case when sn_name = 'BRAZIL'
                        then l_extendedprice * (1 - l_discount)
                        else 0 end) as brazil_rev,
               sum(l_extendedprice * (1 - l_discount)) as total_rev
        from part p join lineitem l on p.p_partkey = l.l_partkey
             join supplier s on s.s_suppkey = l.l_suppkey
             join orders o on o.o_orderkey = l.l_orderkey
             join customer c on c.c_custkey = o.o_custkey
             join custnation n1 on c.c_nationkey = n1.cn_nationkey
             join custregion r1 on n1.cn_regionkey = r1.cr_regionkey
             join suppnation n2 on s.s_nationkey = n2.sn_nationkey
        where cr_name = 'AMERICA'
              and o_orderdate between date '1995-01-01' and date '1996-12-31'
              and p_type = 'ECONOMY ANODIZED STEEL'
        group by year(o_orderdate)
        order by o_year
    """,
    "q10": """
        select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount))
               as revenue, c_acctbal, cn_name, c_phone
        from customer c join orders o on c.c_custkey = o.o_custkey
             join lineitem l on l.l_orderkey = o.o_orderkey
             join custnation n on c.c_nationkey = n.cn_nationkey
        where o_orderdate >= date '1993-10-01'
              and o_orderdate < date '1994-01-01'
              and l_returnflag = 'R'
        group by c_custkey, c_name, c_acctbal, c_phone, cn_name
        order by revenue desc
        limit 20
    """,
    "q12": """
        select l_shipmode,
               sum(case when o_orderpriority = '1-URGENT'
                        or o_orderpriority = '2-HIGH' then 1 else 0 end)
                   as high_line_count,
               sum(case when o_orderpriority <> '1-URGENT'
                        and o_orderpriority <> '2-HIGH' then 1 else 0 end)
                   as low_line_count
        from orders o join lineitem l on o.o_orderkey = l.l_orderkey
        where l_shipmode in ('MAIL', 'SHIP')
              and l_receiptdate >= date '1994-01-01'
              and l_receiptdate < date '1995-01-01'
        group by l_shipmode
        order by l_shipmode
    """,
    "q14": """
        select 100.00 * sum(case when p_type like 'PROMO%'
                                 then l_extendedprice * (1 - l_discount)
                                 else 0 end)
               / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
        from lineitem l join part p on l.l_partkey = p.p_partkey
        where l_shipdate >= date '1995-09-01'
              and l_shipdate < date '1995-10-01'
    """,
    # -- the remaining TPC-H queries, adapted to the star dialect (ANSI
    # joins, globally-unique column names per StarSchemaInfo.scala:127-165;
    # self-joined tables renamed through derived tables). Correlated
    # subqueries route through the host executor's decorrelation.
    "q2": """
        select s_acctbal, s_name, sn_name, p_partkey, p_mfgr, s_address,
               s_phone, s_comment
        from part p join partsupp ps on p.p_partkey = ps.ps_partkey
             join supplier s on s.s_suppkey = ps.ps_suppkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
             join suppregion r on n.sn_regionkey = r.sr_regionkey
        where p_size = 15 and p_type like '%BRASS' and sr_name = 'EUROPE'
              and ps_supplycost =
                  (select min(ps_supplycost)
                   from partsupp join supplier on s_suppkey = ps_suppkey
                        join suppnation on s_nationkey = sn_nationkey
                        join suppregion on sn_regionkey = sr_regionkey
                   where p_partkey = ps_partkey and sr_name = 'EUROPE')
        order by s_acctbal desc, sn_name, s_name, p_partkey
        limit 100
    """,
    "q4": """
        select o_orderpriority, count(*) as order_count
        from orders
        where o_orderdate >= date '1993-07-01'
              and o_orderdate < date '1993-10-01'
              and exists (select 1 from lineitem
                          where l_orderkey = o_orderkey
                                and l_commitdate < l_receiptdate)
        group by o_orderpriority
        order by o_orderpriority
    """,
    "q9": """
        select sn_name as nation, year(o_orderdate) as o_year,
               sum(l_extendedprice * (1 - l_discount)
                   - ps_supplycost * l_quantity) as sum_profit
        from lineitem l join part p on p.p_partkey = l.l_partkey
             join supplier s on s.s_suppkey = l.l_suppkey
             join partsupp ps on ps.ps_partkey = l.l_partkey
                  and ps.ps_suppkey = l.l_suppkey
             join orders o on o.o_orderkey = l.l_orderkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
        where p_name like '%green%'
        group by sn_name, year(o_orderdate)
        order by nation, o_year desc
    """,
    "q11": """
        select ps_partkey, sum(ps_supplycost * ps_availqty) as value
        from partsupp ps join supplier s on ps.ps_suppkey = s.s_suppkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
        where sn_name = 'GERMANY'
        group by ps_partkey
        having sum(ps_supplycost * ps_availqty) >
               (select sum(ps_supplycost * ps_availqty) * 0.0001
                from partsupp join supplier on ps_suppkey = s_suppkey
                     join suppnation on s_nationkey = sn_nationkey
                where sn_name = 'GERMANY')
        order by value desc
    """,
    "q13": """
        select c_count, count(*) as custdist
        from (select c_custkey, count(o_orderkey) as c_count
              from customer left outer join orders
                   on c_custkey = o_custkey
                      and o_comment not like '%special%requests%'
              group by c_custkey) c_orders
        group by c_count
        order by custdist desc, c_count desc
    """,
    "q15": """
        select s_suppkey, s_name, s_address, s_phone, total_revenue
        from supplier s join
             (select l_suppkey as supplier_no,
                     sum(l_extendedprice * (1 - l_discount)) as total_revenue
              from lineitem
              where l_shipdate >= date '1996-01-01'
                    and l_shipdate < date '1996-04-01'
              group by l_suppkey) revenue
             on s.s_suppkey = supplier_no
        where total_revenue =
              (select max(total_revenue2)
               from (select sum(l_extendedprice * (1 - l_discount))
                            as total_revenue2
                     from lineitem
                     where l_shipdate >= date '1996-01-01'
                           and l_shipdate < date '1996-04-01'
                     group by l_suppkey) r2)
        order by s_suppkey
    """,
    "q16": """
        select p_brand, p_type, p_size,
               count(distinct ps_suppkey) as supplier_cnt
        from partsupp ps join part p on p.p_partkey = ps.ps_partkey
        where p_brand <> 'Brand#45'
              and p_type not like 'MEDIUM POLISHED%'
              and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
              and ps_suppkey not in
                  (select s_suppkey from supplier
                   where s_comment like '%Customer%Complaints%')
        group by p_brand, p_type, p_size
        order by supplier_cnt desc, p_brand, p_type, p_size
    """,
    "q17": """
        select sum(l_extendedprice) / 7.0 as avg_yearly
        from lineitem l join part p on p.p_partkey = l.l_partkey
        where p_brand = 'Brand#23' and p_container = 'MED BOX'
              and l_quantity < (select 0.2 * avg(l_quantity)
                                from lineitem
                                where l_partkey = p_partkey)
    """,
    "q18": """
        select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               sum(l_quantity) as total_qty
        from customer c join orders o on c.c_custkey = o.o_custkey
             join lineitem l on o.o_orderkey = l.l_orderkey
        where o_orderkey in (select l_orderkey from lineitem
                             group by l_orderkey
                             having sum(l_quantity) > 300)
        group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        order by o_totalprice desc, o_orderdate
        limit 100
    """,
    "q19": """
        select sum(l_extendedprice * (1 - l_discount)) as revenue
        from lineitem l join part p on p.p_partkey = l.l_partkey
        where (p_brand = 'Brand#12'
               and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
               and l_quantity >= 1 and l_quantity <= 11
               and p_size between 1 and 5
               and l_shipmode in ('AIR', 'REG AIR')
               and l_shipinstruct = 'DELIVER IN PERSON')
              or (p_brand = 'Brand#23'
                  and p_container in ('MED BAG', 'MED BOX', 'MED PKG',
                                      'MED PACK')
                  and l_quantity >= 10 and l_quantity <= 20
                  and p_size between 1 and 10
                  and l_shipmode in ('AIR', 'REG AIR')
                  and l_shipinstruct = 'DELIVER IN PERSON')
              or (p_brand = 'Brand#34'
                  and p_container in ('LG CASE', 'LG BOX', 'LG PACK',
                                      'LG PKG')
                  and l_quantity >= 20 and l_quantity <= 30
                  and p_size between 1 and 15
                  and l_shipmode in ('AIR', 'REG AIR')
                  and l_shipinstruct = 'DELIVER IN PERSON')
    """,
    "q20": """
        select s_name, s_address
        from supplier s join suppnation n on s.s_nationkey = n.sn_nationkey
        where sn_name = 'CANADA'
              and s_suppkey in
                  (select ps_suppkey from partsupp
                   where ps_partkey in (select p_partkey from part
                                        where p_name like '%forest%')
                         and ps_availqty >
                             (select 0.5 * sum(l_quantity)
                              from lineitem
                              where l_partkey = ps_partkey
                                    and l_suppkey = ps_suppkey
                                    and l_shipdate >= date '1994-01-01'
                                    and l_shipdate < date '1995-01-01'))
        order by s_name
    """,
    "q21": """
        select s_name, count(*) as numwait
        from supplier s join lineitem l1 on s.s_suppkey = l1.l_suppkey
             join orders o on o.o_orderkey = l1.l_orderkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
        where o_orderstatus = 'F'
              and l_receiptdate > l_commitdate
              and sn_name = 'SAUDI ARABIA'
              and exists
                  (select 1
                   from (select l_orderkey as l2_orderkey,
                                l_suppkey as l2_suppkey from lineitem) l2
                   where l2_orderkey = l_orderkey
                         and l2_suppkey <> l_suppkey)
              and not exists
                  (select 1
                   from (select l_orderkey as l3_orderkey,
                                l_suppkey as l3_suppkey,
                                l_receiptdate as l3_receiptdate,
                                l_commitdate as l3_commitdate
                         from lineitem) l3
                   where l3_orderkey = l_orderkey
                         and l3_suppkey <> l_suppkey
                         and l3_receiptdate > l3_commitdate)
        group by s_name
        order by numwait desc, s_name
        limit 100
    """,
    "q22": """
        select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
        from (select substring(c_phone from 1 for 2) as cntrycode, c_acctbal,
                     c_custkey
              from customer
              where substring(c_phone from 1 for 2) in
                    ('13', '31', '23', '29', '30', '18', '17')
                    and c_acctbal > (select avg(c_acctbal) from customer
                                     where c_acctbal > 0.00
                                           and substring(c_phone from 1 for 2)
                                               in ('13', '31', '23', '29',
                                                   '30', '18', '17'))
                    and not exists (select 1 from orders
                                    where o_custkey = c_custkey)) custsale
        group by cntrycode
        order by cntrycode
    """,
}
