"""Star Schema Benchmark (SSB) workload — generator, star schema, and the
13 standard queries.

Port counterpart of ``spark_druid_olap_tpu/tools/ssb.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
``generate`` and ``generate_stream`` give the same frames for the same
seed.

BASELINE.json config 3 ("SSB SF30 — denormalized wide fact table"). The
reference demonstrates its BI acceleration on star-schema TPC-H; SSB is the
canonical star-schema benchmark (O'Neil et al.) with a lineorder fact and
date/customer/supplier/part dimensions. All 13 queries are pure star joins
with dimension predicates + grouped aggregation, so every one should
collapse onto the flat index and push down to the device engine.

Synthetic generator (same spirit as tools/tpch.py): value distributions
follow the SSB spec's shapes (25 nations in 5 regions, 10 cities per
nation, MFGR#category/brand hierarchy, 1992-1998 dates) at
``sf``-proportional row counts; it is a workload generator for
benchmarking, not a dbgen clone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.metadata.star import StarRelation, StarSchema

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]


def _nation_city(rng, n):
    region = rng.choice(REGIONS, n)
    nation = np.array([rng.choice(NATIONS[r]) for r in region], dtype=object)
    # SSB city = first 9 chars of nation + digit 0..9
    city = np.array([f"{nat[:9]:<9}{d}" for nat, d in
                     zip(nation, rng.integers(0, 10, n))], dtype=object)
    return region, nation, city


def _sizes(sf: float):
    n_lo = max(1000, int(6_000_000 * sf))
    n_cust = max(60, int(30_000 * sf))
    n_supp = max(40, int(2_000 * sf))
    n_part = max(80, int(200_000 * min(1.0, 1 + np.log2(max(sf, 1e-6)) / 10)
                         * sf + 2000 * (sf ** 0.5)))
    return n_lo, n_cust, n_supp, n_part


def _gen_dims(rng, sf: float) -> Dict[str, pd.DataFrame]:
    _, n_cust, n_supp, n_part = _sizes(sf)

    dates = pd.date_range("1992-01-01", "1998-12-31", freq="D")
    nd = len(dates)
    date = pd.DataFrame({
        "d_datekey": dates,
        "d_year": dates.year.astype(np.int64),
        "d_month": np.array([MONTHS[m - 1] for m in dates.month],
                            dtype=object),
        "d_yearmonthnum": (dates.year * 100 + dates.month).astype(np.int64),
        "d_yearmonth": np.array(
            [f"{MONTHS[m - 1]}{y}" for y, m in zip(dates.year, dates.month)],
            dtype=object),
        "d_daynuminweek": (dates.dayofweek + 1).astype(np.int64),
        "d_monthnuminyear": dates.month.astype(np.int64),
        "d_weeknuminyear": pd.Index(dates.isocalendar().week).astype(np.int64),
        "d_sellingseason": np.array(
            ["Winter" if m in (12, 1, 2) else "Spring" if m in (3, 4, 5)
             else "Summer" if m in (6, 7, 8) else "Fall"
             for m in dates.month], dtype=object),
    })

    creg, cnat, ccity = _nation_city(rng, n_cust)
    customer = pd.DataFrame({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
        "c_city": ccity, "c_nation": cnat, "c_region": creg,
        "c_mktsegment": rng.choice(["AUTOMOBILE", "BUILDING", "FURNITURE",
                                    "MACHINERY", "HOUSEHOLD"], n_cust),
    })

    sreg, snat, scity = _nation_city(rng, n_supp)
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
        "s_city": scity, "s_nation": snat, "s_region": sreg,
    })

    mfgr = rng.integers(1, 6, n_part)
    cat = mfgr * 10 + rng.integers(1, 6, n_part)
    brand = cat * 100 + rng.integers(1, 41, n_part)
    part = pd.DataFrame({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": rng.choice(["almond", "antique", "aquamarine", "azure",
                              "beige", "bisque", "black", "blanched"],
                             n_part),
        "p_mfgr": np.array([f"MFGR#{m}" for m in mfgr], dtype=object),
        "p_category": np.array([f"MFGR#{c}" for c in cat], dtype=object),
        "p_brand1": np.array([f"MFGR#{b}" for b in brand], dtype=object),
        "p_color": rng.choice(["red", "green", "blue", "ivory", "maroon"],
                              n_part),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
    })
    return {"date": date, "customer": customer, "supplier": supplier,
            "part": part}


def _gen_lineorder(rng, dims: Dict[str, pd.DataFrame], n_lo: int,
                   start_key: int = 1) -> pd.DataFrame:
    dates = pd.DatetimeIndex(dims["date"]["d_datekey"])
    nd = len(dates)
    n_cust = len(dims["customer"])
    n_supp = len(dims["supplier"])
    n_part = len(dims["part"])
    od = rng.integers(0, nd, n_lo)
    qty = rng.integers(1, 51, n_lo).astype(np.int64)
    eprice = np.round(rng.uniform(90.0, 105_000.0, n_lo), 2)
    disc = rng.integers(0, 11, n_lo).astype(np.int64)
    rev = np.round(eprice * (100 - disc) / 100.0, 2)
    return pd.DataFrame({
        "lo_orderkey": np.arange(start_key, start_key + n_lo,
                                 dtype=np.int64),
        "lo_custkey": rng.integers(1, n_cust + 1, n_lo).astype(np.int64),
        "lo_partkey": rng.integers(1, n_part + 1, n_lo).astype(np.int64),
        "lo_suppkey": rng.integers(1, n_supp + 1, n_lo).astype(np.int64),
        "lo_orderdate": dates[od],
        "lo_quantity": qty,
        "lo_extendedprice": eprice,
        "lo_discount": disc,
        "lo_revenue": rev,
        "lo_supplycost": np.round(rng.uniform(50.0, 60_000.0, n_lo), 2),
        "lo_shipmode": rng.choice(["AIR", "FOB", "MAIL", "RAIL", "SHIP",
                                   "TRUCK", "REG AIR"], n_lo),
    })


def generate(sf: float = 0.01,
             seed: int = 20260729) -> Dict[str, pd.DataFrame]:
    rng = np.random.default_rng(seed)
    n_lo, _, _, _ = _sizes(sf)
    dims = _gen_dims(rng, sf)
    lineorder = _gen_lineorder(rng, dims, n_lo)
    return {"lineorder": lineorder, **dims}


def generate_stream(sf: float, lineorder_path: str, seed: int = 20260729,
                    batch_rows: int = 1 << 22):
    """Out-of-core generator for SF where the 6M*sf-row lineorder (and a
    fortiori the ~30-column flat index) must not materialize in pandas —
    SF30 is 180M rows. Dimensions stay in memory (largest is part, ~6M
    rows at SF30); lineorder is generated chunk-by-chunk straight into a
    Parquet file. Returns (dims, n_lineorder_rows)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    n_lo, _, _, _ = _sizes(sf)
    dims = _gen_dims(rng, sf)
    writer = None
    written = 0
    try:
        while written < n_lo:
            n = min(int(batch_rows), n_lo - written)
            chunk = _gen_lineorder(rng, dims, n, start_key=written + 1)
            table = pa.Table.from_pandas(chunk, preserve_index=False)
            if writer is None:
                writer = pq.ParquetWriter(lineorder_path, table.schema)
            writer.write_table(table)
            written += n
    finally:
        if writer is not None:
            writer.close()
    return dims, written


def flatten_stream(dims: Dict[str, pd.DataFrame], lineorder_path: str,
                   out_path: str, batch_rows: int = 1 << 20) -> int:
    """Chunked star-join of the streamed lineorder against the in-memory
    dimensions (same machinery as the TPC-H SF10 out-of-core flatten).
    Returns flat rows written."""
    from spark_druid_olap_tpu_torch.segment.stream_ingest import (
        flatten_join_stream)
    joins = [
        (dims["date"], "lo_orderdate", "d_datekey"),
        (dims["customer"], "lo_custkey", "c_custkey"),
        (dims["supplier"], "lo_suppkey", "s_suppkey"),
        (dims["part"], "lo_partkey", "p_partkey"),
    ]
    return flatten_join_stream(lineorder_path, out_path, joins,
                               batch_rows=batch_rows)


def flatten(tables) -> pd.DataFrame:
    df = tables["lineorder"].merge(tables["date"], left_on="lo_orderdate",
                                   right_on="d_datekey")
    df = df.merge(tables["customer"], left_on="lo_custkey",
                  right_on="c_custkey")
    df = df.merge(tables["supplier"], left_on="lo_suppkey",
                  right_on="s_suppkey")
    df = df.merge(tables["part"], left_on="lo_partkey", right_on="p_partkey")
    return df.reset_index(drop=True)


def star_schema(flat_datasource: str = "ssb_flat") -> StarSchema:
    return StarSchema("lineorder", flat_datasource, [
        StarRelation("lineorder", "date", (("lo_orderdate", "d_datekey"),)),
        StarRelation("lineorder", "customer",
                     (("lo_custkey", "c_custkey"),)),
        StarRelation("lineorder", "supplier",
                     (("lo_suppkey", "s_suppkey"),)),
        StarRelation("lineorder", "part", (("lo_partkey", "p_partkey"),)),
    ])


def setup_context(ctx, sf: float = 0.01, seed: int = 20260729,
                  target_rows: int = 1 << 20, flat_only: bool = False):
    tables = generate(sf, seed)
    flat = flatten(tables)
    ctx.ingest_dataframe("ssb_flat", flat, time_column="lo_orderdate",
                         target_rows=target_rows)
    if not flat_only:
        for name, df in tables.items():
            tcol = {"lineorder": "lo_orderdate"}.get(name)
            ctx.ingest_dataframe(name, df, time_column=tcol,
                                 target_rows=target_rows)
    ctx.register_star_schema(star_schema("ssb_flat"))
    return tables, flat


QUERIES: Dict[str, str] = {
    "q1.1": """
        select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder join date on lo_orderdate = d_datekey
        where d_year = 1993 and lo_discount between 1 and 3
              and lo_quantity < 25
    """,
    "q1.2": """
        select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder join date on lo_orderdate = d_datekey
        where d_yearmonthnum = 199401 and lo_discount between 4 and 6
              and lo_quantity between 26 and 35
    """,
    "q1.3": """
        select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder join date on lo_orderdate = d_datekey
        where d_weeknuminyear = 6 and d_year = 1994
              and lo_discount between 5 and 7
              and lo_quantity between 26 and 35
    """,
    "q2.1": """
        select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder join date on lo_orderdate = d_datekey
             join part on lo_partkey = p_partkey
             join supplier on lo_suppkey = s_suppkey
        where p_category = 'MFGR#12' and s_region = 'AMERICA'
        group by d_year, p_brand1 order by d_year, p_brand1
    """,
    "q2.2": """
        select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder join date on lo_orderdate = d_datekey
             join part on lo_partkey = p_partkey
             join supplier on lo_suppkey = s_suppkey
        where p_brand1 between 'MFGR#2221' and 'MFGR#2228'
              and s_region = 'ASIA'
        group by d_year, p_brand1 order by d_year, p_brand1
    """,
    "q2.3": """
        select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder join date on lo_orderdate = d_datekey
             join part on lo_partkey = p_partkey
             join supplier on lo_suppkey = s_suppkey
        where p_brand1 = 'MFGR#2239' and s_region = 'EUROPE'
        group by d_year, p_brand1 order by d_year, p_brand1
    """,
    "q3.1": """
        select c_nation, s_nation, d_year, sum(lo_revenue) as lo_revenue
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
        where c_region = 'ASIA' and s_region = 'ASIA'
              and d_year >= 1992 and d_year <= 1997
        group by c_nation, s_nation, d_year
        order by d_year asc, lo_revenue desc
    """,
    "q3.2": """
        select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
        where c_nation = 'UNITED STATES' and s_nation = 'UNITED STATES'
              and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, lo_revenue desc
    """,
    "q3.3": """
        select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
        where (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
              and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
              and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, lo_revenue desc
    """,
    "q3.4": """
        select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
        where (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
              and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
              and d_yearmonth = 'Dec1997'
        group by c_city, s_city, d_year
        order by d_year asc, lo_revenue desc
    """,
    "q4.1": """
        select d_year, c_nation,
               sum(lo_revenue - lo_supplycost) as profit
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
             join part on lo_partkey = p_partkey
        where c_region = 'AMERICA' and s_region = 'AMERICA'
              and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, c_nation order by d_year, c_nation
    """,
    "q4.2": """
        select d_year, s_nation, p_category,
               sum(lo_revenue - lo_supplycost) as profit
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
             join part on lo_partkey = p_partkey
        where c_region = 'AMERICA' and s_region = 'AMERICA'
              and (d_year = 1997 or d_year = 1998)
              and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, s_nation, p_category
        order by d_year, s_nation, p_category
    """,
    "q4.3": """
        select d_year, s_city, p_brand1,
               sum(lo_revenue - lo_supplycost) as profit
        from lineorder join date on lo_orderdate = d_datekey
             join customer on lo_custkey = c_custkey
             join supplier on lo_suppkey = s_suppkey
             join part on lo_partkey = p_partkey
        where s_nation = 'UNITED STATES'
              and (d_year = 1997 or d_year = 1998)
              and p_category = 'MFGR#14'
        group by d_year, s_city, p_brand1
        order by d_year, s_city, p_brand1
    """,
}
