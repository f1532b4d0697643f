"""TPC-H data generation.

Port of ``spark_druid_olap_tpu/tools/tpch.py:generate``, copied so the port
and ``chip_smoke.py`` need nothing of the JAX package: the same seed gives
the same eight tables, value for value (lineitem's draws follow the other
tables' in one random stream, so the whole generator is kept).

The generator is a fast, deterministic, schema-faithful approximation of
dbgen (uniform draws over real TPC-H value domains); answers are checked
differentially against an oracle on the same frame, so exact dbgen
distributions are unnecessary.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

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
