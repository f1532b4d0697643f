"""TPC-H data, flat on the lineitem grain (``tpch_flat``), from a seed.

A frozen copy of the port's ``tools/tpch.py`` generator, rewritten for the
benchmark: the same tables, columns and value domains (dbgen's nations,
regions, segments, priorities, ship modes and instructions, the 150 part
types and 40 containers; 1-7 lines an order, ship 1-121 days after the
order, commit 30-90, receipt 1-30 after the ship date; the supplier of a
line is one of its part's four partsupp suppliers; return flag R / A for
lines received by 1995-06-17, else N; line status O after 1995-06-17,
else F) drawn in whole arrays, and the flat star joined by index gathers
instead of pandas merges. One departure: an order's line count is a
shuffle of a fixed multiset of 1..7 rather than seven-sided dice, so every
seed has the same number of lines (a fixed amount of work per seed).

The flat columns are the merge's, 68 of them: lineitem, orders, customer,
custnation (``cn_*``), custregion (``cr_*``), part, supplier, suppnation
(``sn_*``), suppregion (``sr_*``), partsupp.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from olapbench.data.table import Table

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
TYPE_SYLLABLES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                   "PROMO"),
                  ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
                  ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
TYPES = [f"{a} {b} {c}" for a in TYPE_SYLLABLES[0]
         for b in TYPE_SYLLABLES[1] for c in TYPE_SYLLABLES[2]]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
COLORS = ["green", "blue", "red", "ivory", "magenta", "plum", "puff",
          "powder", "forest", "lace"]
FIRST_ORDER_DAY = np.datetime64("1992-01-01", "D")
ORDER_DAYS = 2406
CUTOFF = np.datetime64("1995-06-17", "D")


def _days(d) -> np.ndarray:
    return (np.asarray(d, "datetime64[D]")
            - np.datetime64("1970-01-01", "D")).astype(np.int32)


def _s(a) -> pa.Array:
    return pc.cast(pa.array(np.asarray(a)), pa.string())


def _join(*parts) -> pa.Array:
    """Element-wise concatenation of Arrow strings and literal strings."""
    parts = [pa.scalar(p) if isinstance(p, str) else p for p in parts]
    return pc.binary_join_element_wise(*parts, "")


def _pad(a, width: int) -> pa.Array:
    return pc.utf8_lpad(_s(a), width, "0")


def sizes(sf: float):
    """Rows of orders, customer, part and supplier at ``sf``."""
    return (max(10, int(1_500_000 * sf)), max(5, int(150_000 * sf)),
            max(5, int(200_000 * sf)), max(3, int(10_000 * sf)))


def generate(sf: float, seed: int) -> Table:
    r = np.random.default_rng(seed)
    n_orders, n_cust, n_part, n_supp = sizes(sf)

    # orders
    lines_per = r.permutation(np.resize(np.arange(1, 8), n_orders))
    o_idx = np.repeat(np.arange(n_orders), lines_per)
    n_li = len(o_idx)
    o_cust = r.integers(0, n_cust, n_orders)
    o_day = FIRST_ORDER_DAY + r.integers(0, ORDER_DAYS, n_orders
                                         ).astype("timedelta64[D]")

    # lineitem
    li_oday = o_day[o_idx]
    ship = li_oday + r.integers(1, 122, n_li).astype("timedelta64[D]")
    commit = li_oday + r.integers(30, 91, n_li).astype("timedelta64[D]")
    receipt = ship + r.integers(1, 31, n_li).astype("timedelta64[D]")
    l_part = r.integers(1, n_part + 1, n_li)
    which = r.integers(0, 4, n_li)   # which of the part's four suppliers
    l_supp = ((l_part + which * (n_supp // 4 + 1)) % n_supp) + 1
    qty = r.integers(1, 51, n_li)
    starts = np.cumsum(lines_per) - lines_per
    t = Table("tpch_flat", n_li, "l_shipdate")
    t.add("l_orderkey", "int", (o_idx + 1).astype(np.int64))
    t.add("l_partkey", "int", l_part)
    t.add("l_suppkey", "int", l_supp)
    t.add("l_linenumber", "int", np.arange(n_li) - starts[o_idx] + 1)
    t.add("l_quantity", "int", qty)
    t.add("l_extendedprice", "float",
          np.round(qty * (900 + (l_part % 1000) / 10.0), 2))
    t.add("l_discount", "float", np.round(r.integers(0, 11, n_li) / 100.0, 2))
    t.add("l_tax", "float", np.round(r.integers(0, 9, n_li) / 100.0, 2))
    ra = r.integers(0, 2, n_li)
    t.add_words("l_returnflag", ["R", "A", "N"],
                np.where(receipt <= CUTOFF, ra, 2))
    t.add_words("l_linestatus", ["O", "F"], np.where(ship > CUTOFF, 0, 1))
    t.add("l_shipdate", "date", _days(ship))
    t.add("l_commitdate", "date", _days(commit))
    t.add("l_receiptdate", "date", _days(receipt))
    t.add_words("l_shipinstruct", INSTRUCTS,
                r.integers(0, len(INSTRUCTS), n_li))
    t.add_words("l_shipmode", SHIPMODES, r.integers(0, len(SHIPMODES), n_li))
    t.add_text("l_comment", _join("line comment ", _s(np.arange(n_li))))

    # orders, gathered by the line's order
    t.add("o_orderkey", "int", np.arange(1, n_orders + 1, dtype=np.int64),
          o_idx)
    t.add("o_custkey", "int", o_cust + 1, o_idx)
    status = r.choice(3, n_orders, p=[0.49, 0.49, 0.02])
    t.add_words("o_orderstatus", ["O", "F", "P"], status, o_idx)
    t.add("o_totalprice", "float",
          np.round(r.uniform(800, 500000, n_orders), 2), o_idx)
    t.add("o_orderdate", "date", _days(o_day), o_idx)
    t.add_words("o_orderpriority", PRIORITIES,
                r.integers(0, len(PRIORITIES), n_orders), o_idx)
    t.add_words("o_clerk", [f"Clerk#{k:09d}" for k in range(1, 1001)],
                np.arange(n_orders) % 1000, o_idx)
    t.add("o_shippriority", "int", np.zeros(n_orders, np.int64), o_idx)
    special = pa.array(r.random(n_orders) < 0.01)
    t.add_text("o_comment", pc.if_else(
        special, pa.scalar("special requests"),
        _join("order comment ", _s(np.arange(n_orders)))), o_idx)

    # customer, gathered by the order's customer
    c_idx = o_cust[o_idx]
    c_nat = r.integers(0, 25, n_cust)
    ci = np.arange(n_cust)
    t.add("c_custkey", "int", ci + 1, c_idx)
    t.add_text("c_name", _join("Customer#", _pad(ci + 1, 9)), c_idx)
    t.add_text("c_address", _join("caddr", _s(ci)), c_idx)
    t.add("c_nationkey", "int", c_nat, c_idx)
    t.add_text("c_phone", _join(_s(10 + ci % 25), "-", _pad(ci, 7)), c_idx)
    t.add("c_acctbal", "float",
          np.round(r.uniform(-999.99, 9999.99, n_cust), 2), c_idx)
    t.add_words("c_mktsegment", SEGMENTS,
                r.integers(0, len(SEGMENTS), n_cust), c_idx)
    t.add_text("c_comment", _join("customer comment ", _s(ci)), c_idx)

    nat_names = [n for n, _ in NATIONS]
    nat_region = np.array([k for _, k in NATIONS])
    cn = c_nat[c_idx]
    t.add("cn_nationkey", "int", np.arange(25, dtype=np.int64), cn)
    t.add_words("cn_name", nat_names, np.arange(25), cn)
    t.add("cn_regionkey", "int", nat_region.astype(np.int64), cn)
    t.add_words("cn_comment", [f"nation {i}" for i in range(25)],
                np.arange(25), cn)
    cr = nat_region[cn]
    t.add("cr_regionkey", "int", np.arange(5, dtype=np.int64), cr)
    t.add_words("cr_name", REGIONS, np.arange(5), cr)
    t.add_words("cr_comment", [f"region {i}" for i in range(5)],
                np.arange(5), cr)

    # part, gathered by the line's part
    p_idx = l_part - 1
    pi = np.arange(n_part)
    t.add("p_partkey", "int", pi + 1, p_idx)
    colors = pa.array(COLORS)
    names = [pc.take(colors, pa.array(r.integers(0, len(COLORS), n_part)))
             for _ in range(3)]
    t.add_text("p_name", _join("part ", _s(pi + 1), " ", names[0], " ",
                               names[1], " ", names[2]), p_idx)
    t.add_words("p_mfgr", [f"Manufacturer#{k}" for k in range(1, 6)],
                pi % 5, p_idx)
    t.add_words("p_brand", [f"Brand#{a}{b}" for a in range(1, 6)
                            for b in range(1, 6)],
                (pi % 5) * 5 + (pi // 5) % 5, p_idx)
    t.add_words("p_type", TYPES, r.integers(0, len(TYPES), n_part), p_idx)
    t.add("p_size", "int", r.integers(1, 51, n_part), p_idx)
    t.add_words("p_container", CONTAINERS,
                r.integers(0, len(CONTAINERS), n_part), p_idx)
    t.add("p_retailprice", "float",
          np.round(900 + ((pi + 1) % 1000) / 10.0, 2), p_idx)
    t.add_text("p_comment", _join("part comment ", _s(pi)), p_idx)

    # supplier, gathered by the line's supplier
    s_idx = l_supp - 1
    si = np.arange(n_supp)
    s_nat = r.integers(0, 25, n_supp)
    t.add("s_suppkey", "int", si + 1, s_idx)
    t.add_text("s_name", _join("Supplier#", _pad(si + 1, 9)), s_idx)
    t.add_text("s_address", _join("addr", _s(si)), s_idx)
    t.add("s_nationkey", "int", s_nat, s_idx)
    t.add_text("s_phone", _join(_s(r.integers(10, 35, n_supp)), "-",
                                _pad(si, 7)), s_idx)
    t.add("s_acctbal", "float",
          np.round(r.uniform(-999.99, 9999.99, n_supp), 2), s_idx)
    t.add_text("s_comment", pc.if_else(
        pa.array(r.random(n_supp) < 0.005), pa.scalar("Customer Complaints"),
        _join("supplier comment ", _s(si))), s_idx)
    sn = s_nat[s_idx]
    t.add("sn_nationkey", "int", np.arange(25, dtype=np.int64), sn)
    t.add_words("sn_name", nat_names, np.arange(25), sn)
    t.add("sn_regionkey", "int", nat_region.astype(np.int64), sn)
    t.add_words("sn_comment", [f"nation {i}" for i in range(25)],
                np.arange(25), sn)
    sr = nat_region[sn]
    t.add("sr_regionkey", "int", np.arange(5, dtype=np.int64), sr)
    t.add_words("sr_name", REGIONS, np.arange(5), sr)
    t.add_words("sr_comment", [f"region {i}" for i in range(5)],
                np.arange(5), sr)

    # partsupp: part p's four rows hold suppliers
    # ((p + i * (n_supp // 4 + 1)) % n_supp) + 1, i = 0..3
    ps_idx = p_idx * 4 + which
    ps_part = np.repeat(pi + 1, 4)
    ps_supp = ((ps_part + np.tile(np.arange(4), n_part) * (n_supp // 4 + 1))
               % n_supp) + 1
    n_ps = len(ps_part)
    t.add("ps_partkey", "int", ps_part, ps_idx)
    t.add("ps_suppkey", "int", ps_supp, ps_idx)
    t.add("ps_availqty", "int", r.integers(1, 10000, n_ps), ps_idx)
    t.add("ps_supplycost", "float",
          np.round(r.uniform(1.0, 1000.0, n_ps), 2), ps_idx)
    t.add_text("ps_comment", _join("ps comment ", _s(np.arange(n_ps))),
               ps_idx)
    return t
