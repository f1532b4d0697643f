"""Star Schema Benchmark data, flat (``ssb_flat``), from a seed.

Every column of SSB's lineorder and its four dimensions (O'Neil, O'Neil,
Chen, Revilak, "Star Schema Benchmark", rev. 3, 2009, section 2), 58 in
all, in the types SSB's dbgen writes: integers for keys, counts, money
(whole cents) and flags, dates for the two lineorder dates, text for the
rest. The value domains are those of the port's ``tools/ssb.py`` (25
nations in 5 regions, 10 cities per nation named by the first 9 letters of
the nation and a digit, the MFGR#mfgr / category / brand hierarchy, order
dates 1992-01-01 to 1998-12-31, quantity 1-50, discount 0-10), widened
with dbgen's rules for the columns that generator leaves out:

- an order has 1-7 lines, each line its own part, supplier, quantity,
  discount, tax (0-8), ship mode and commit date (30-90 days after the
  order); the order's customer, date, priority (TPC-H's five), ship
  priority ("0") and total price are shared by its lines;
- money in whole cents: extended price = quantity x the part's retail
  price (TPC-H's formula for ``p_retailprice``), revenue = extended price
  x (100 - discount) / 100, supply cost = 6/10 of the retail price, total
  price = the order's sum of revenue x (100 + tax) / 100;
- the date dimension's names, day numbers and flags of each calendar day;
- addresses (10-25 letters and digits) and phones (``NN-NNN-NNN-NNNN``, NN
  the nation's number + 10) of customers and suppliers; TPC-H's 150 part
  types and 40 containers.

An order's line count is a shuffle of a fixed multiset of 1..7 rather
than seven-sided dice, so every seed has the same number of lines (a fixed
amount of work per seed). Lineorder is joined to its dimensions by index
gathers; each dimension's key stays beside the lineorder's foreign key.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc

from olapbench.data.table import Table

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # five per region, in REGIONS' order
    "ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE",
    "ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES",
    "CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM",
    "FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM",
    "EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"]
# city = first 9 letters of the nation, padded to 9, then a digit 0-9
CITIES = [f"{n[:9]:<9}{d}" for n in NATIONS for d in range(10)]
MONTH_NAMES = ["January", "February", "March", "April", "May", "June",
               "July", "August", "September", "October", "November",
               "December"]
MONTHS = [m[:3] for m in MONTH_NAMES]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW"]
PART_NAMES = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
              "black", "blanched"]
COLORS = ["red", "green", "blue", "ivory", "maroon"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR"]
SEASONS = ["Winter", "Spring", "Summer", "Fall"]
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                   "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
HOLIDAYS = {(1, 1), (7, 4), (12, 24), (12, 25), (12, 31)}   # (month, day)
ALNUM = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                      b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8)
FIRST_DAY, LAST_DAY = "1992-01-01", "1998-12-31"


def sizes(sf: float):
    """Rows of orders, customer, supplier and part at ``sf``."""
    n_ord = max(250, int(1_500_000 * sf))
    n_cust = max(60, int(30_000 * sf))
    n_supp = max(40, int(2_000 * sf))
    n_part = max(80, int(200_000 * min(1.0, 1 + np.log2(max(sf, 1e-6)) / 10)
                         * sf + 2000 * (sf ** 0.5)))
    return n_ord, n_cust, n_supp, n_part


def _numbered(prefix: str, n: int) -> pa.Array:
    """``prefix`` + 9-digit 1-based row numbers, as Arrow strings."""
    num = pc.utf8_lpad(pc.cast(pa.array(np.arange(1, n + 1)), pa.string()),
                       9, "0")
    return pc.binary_join_element_wise(pa.scalar(prefix), num, "")


def _addresses(rng, n: int) -> pa.Array:
    """``n`` strings of 10-25 letters and digits."""
    chars = ALNUM[rng.integers(0, len(ALNUM), (n, 25))]
    lens = rng.integers(10, 26, n)
    keep = np.arange(25)[None, :] < lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets), pa.py_buffer(chars[keep].tobytes()))


def _phones(rng, nation: np.ndarray) -> pa.Array:
    """``NN-NNN-NNN-NNNN`` with NN the nation's number + 10."""
    n = len(nation)
    parts = [nation + 10, rng.integers(100, 1000, n),
             rng.integers(100, 1000, n), rng.integers(1000, 10000, n)]
    s = [pc.cast(pa.array(p), pa.string()) for p in parts]
    return pc.binary_join_element_wise(s[0], s[1], s[2], s[3], "-")


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """TPC-H's ``p_retailprice`` of 1-based part keys, in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def generate(sf: float, seed: int) -> Table:
    rng = np.random.default_rng(seed)
    n_ord, n_cust, n_supp, n_part = sizes(sf)

    dates = pd.date_range(FIRST_DAY, LAST_DAY, freq="D")
    nd = len(dates)
    first = int((np.datetime64(FIRST_DAY, "D")
                 - np.datetime64("1970-01-01", "D")).astype(int))

    # orders, and their lines
    lines_per = rng.permutation(np.resize(np.arange(1, 8), n_ord))
    o_idx = np.repeat(np.arange(n_ord), lines_per)
    n_lo = len(o_idx)
    starts = np.cumsum(lines_per) - lines_per
    o_cust = rng.integers(0, n_cust, n_ord)
    o_day = rng.integers(0, nd, n_ord)
    o_prio = rng.integers(0, len(PRIORITIES), n_ord)
    cust, day = o_cust[o_idx], o_day[o_idx]
    part = rng.integers(0, n_part, n_lo)
    supp = rng.integers(0, n_supp, n_lo)
    qty = rng.integers(1, 51, n_lo)
    disc = rng.integers(0, 11, n_lo)
    tax = rng.integers(0, 9, n_lo)
    retail = retail_cents(part + 1)
    eprice = qty * retail
    revenue = eprice * (100 - disc) // 100
    total = np.add.reduceat(revenue * (100 + tax) // 100, starts)

    t = Table("ssb_flat", n_lo, "lo_orderdate")
    t.add("lo_orderkey", "int", (o_idx + 1).astype(np.int64))
    t.add("lo_linenumber", "int", np.arange(n_lo) - starts[o_idx] + 1)
    t.add("lo_custkey", "int", cust + 1)
    t.add("lo_partkey", "int", part + 1)
    t.add("lo_suppkey", "int", supp + 1)
    t.add("lo_orderdate", "date", (first + day).astype(np.int32))
    t.add_words("lo_orderpriority", PRIORITIES, o_prio, o_idx)
    t.add_words("lo_shippriority", ["0"], np.zeros(n_lo, np.int64))
    t.add("lo_quantity", "int", qty)
    t.add("lo_extendedprice", "int", eprice)
    t.add("lo_ordtotalprice", "int", total, o_idx)
    t.add("lo_discount", "int", disc)
    t.add("lo_revenue", "int", revenue)
    t.add("lo_supplycost", "int", 6 * retail // 10)
    t.add("lo_tax", "int", tax)
    t.add("lo_commitdate", "date",
          (first + day + rng.integers(30, 91, n_lo)).astype(np.int32))
    t.add_words("lo_shipmode", SHIPMODES,
                rng.integers(0, len(SHIPMODES), n_lo))

    # date, gathered by the order day
    year = dates.year.to_numpy().astype(np.int64)
    month = dates.month.to_numpy()
    dom = dates.day.to_numpy()
    dow = (dates.dayofweek.to_numpy() + 1) % 7          # Sunday = 0
    t.add("d_datekey", "date", (first + np.arange(nd)).astype(np.int32), day)
    t.add_words("d_date", [f"{MONTH_NAMES[m - 1]} {d}, {y}" for y, m, d
                           in zip(year, month, dom)], np.arange(nd), day)
    t.add_words("d_dayofweek", DAY_NAMES, dow, day)
    t.add_words("d_month", MONTH_NAMES, month - 1, day)
    t.add("d_year", "int", year, day)
    t.add("d_yearmonthnum", "int", year * 100 + month, day)
    ym = [f"{MONTHS[m - 1]}{y}" for y, m in zip(year, month)]
    words, codes = np.unique(np.array(ym), return_inverse=True)
    t.add_words("d_yearmonth", words, codes, day)
    t.add("d_daynuminweek", "int", (dow + 1).astype(np.int64), day)
    t.add("d_daynuminmonth", "int", dom.astype(np.int64), day)
    t.add("d_daynuminyear", "int",
          dates.dayofyear.to_numpy().astype(np.int64), day)
    t.add("d_monthnuminyear", "int", month.astype(np.int64), day)
    t.add("d_weeknuminyear", "int",
          dates.isocalendar().week.to_numpy().astype(np.int64), day)
    t.add_words("d_sellingseason", SEASONS,
                np.array([0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 0])[month - 1], day)
    t.add("d_lastdayinweekfl", "int", (dow == 6).astype(np.int64), day)
    t.add("d_lastdayinmonthfl", "int",
          dates.is_month_end.astype(np.int64), day)
    t.add("d_holidayfl", "int", np.array(
        [(m, d) in HOLIDAYS for m, d in zip(month, dom)], np.int64), day)
    t.add("d_weekdayfl", "int", ((dow >= 1) & (dow <= 5)).astype(np.int64),
          day)

    # customer, gathered by the customer
    nat = rng.integers(0, 5, n_cust) + 5 * rng.integers(0, 5, n_cust)
    city = nat * 10 + rng.integers(0, 10, n_cust)
    t.add("c_custkey", "int", np.arange(1, n_cust + 1, dtype=np.int64), cust)
    t.add_text("c_name", _numbered("Customer#", n_cust), cust)
    t.add_text("c_address", _addresses(rng, n_cust), cust)
    t.add_words("c_city", CITIES, city, cust)
    t.add_words("c_nation", NATIONS, nat, cust)
    t.add_words("c_region", REGIONS, nat // 5, cust)
    t.add_text("c_phone", _phones(rng, nat), cust)
    t.add_words("c_mktsegment", SEGMENTS,
                rng.integers(0, len(SEGMENTS), n_cust), cust)

    # supplier, gathered by the supplier
    nat = rng.integers(0, 5, n_supp) + 5 * rng.integers(0, 5, n_supp)
    city = nat * 10 + rng.integers(0, 10, n_supp)
    t.add("s_suppkey", "int", np.arange(1, n_supp + 1, dtype=np.int64), supp)
    t.add_text("s_name", _numbered("Supplier#", n_supp), supp)
    t.add_text("s_address", _addresses(rng, n_supp), supp)
    t.add_words("s_city", CITIES, city, supp)
    t.add_words("s_nation", NATIONS, nat, supp)
    t.add_words("s_region", REGIONS, nat // 5, supp)
    t.add_text("s_phone", _phones(rng, nat), supp)

    # part, gathered by the part: category = mfgr x 10 + 1-5, brand =
    # category x 100 + 1-40
    mfgr = rng.integers(1, 6, n_part)
    cat = mfgr * 10 + rng.integers(1, 6, n_part)
    brand = cat * 100 + rng.integers(1, 41, n_part)
    t.add("p_partkey", "int", np.arange(1, n_part + 1, dtype=np.int64), part)
    t.add_words("p_name", PART_NAMES,
                rng.integers(0, len(PART_NAMES), n_part), part)
    t.add_words("p_mfgr", [f"MFGR#{m}" for m in range(1, 6)], mfgr - 1, part)
    cats = [m * 10 + c for m in range(1, 6) for c in range(1, 6)]
    t.add_words("p_category", [f"MFGR#{c}" for c in cats],
                np.searchsorted(cats, cat), part)
    brands = [c * 100 + b for c in cats for b in range(1, 41)]
    t.add_words("p_brand1", [f"MFGR#{b}" for b in brands],
                np.searchsorted(brands, brand), part)
    t.add_words("p_color", COLORS, rng.integers(0, len(COLORS), n_part), part)
    t.add_words("p_type", TYPES, rng.integers(0, len(TYPES), n_part), part)
    t.add("p_size", "int", rng.integers(1, 51, n_part), part)
    t.add_words("p_container", CONTAINERS,
                rng.integers(0, len(CONTAINERS), n_part), part)
    return t
