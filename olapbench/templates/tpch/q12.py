"""TPC-H Q12, shipping modes and order priority.

Substitution parameters (TPC-H spec 2.4.12.3): SHIPMODE1 and SHIPMODE2,
two different modes of the 7; DATE, January 1 of 1993-1997.
"""

import numpy as np

from olapbench.data.tpch import SHIPMODES

SQL = """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                or o_orderpriority = '2-HIGH' then 1 else 0 end)
           as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                and o_orderpriority <> '2-HIGH' then 1 else 0 end)
           as low_line_count
from orders o join lineitem l on o.o_orderkey = l.l_orderkey
where l_shipmode in ('{m1}', '{m2}')
      and l_receiptdate >= date '{year}-01-01'
      and l_receiptdate < date '{year1}-01-01'
group by l_shipmode
order by l_shipmode
"""
DOMAIN = {"mode": list(range(7)), "step": list(range(1, 7)),
          "year": list(range(1993, 1998))}
ORDER = [("l_shipmode", True)]
COLUMNS = ["l_shipmode", "o_orderpriority", "l_receiptdate"]


def derive(p):
    return {"m1": SHIPMODES[p["mode"]],
            "m2": SHIPMODES[(p["mode"] + p["step"]) % 7],
            "year1": p["year"] + 1}


def time_range(p):
    return None


def reference(t, p, P):
    from olapbench.plain import day
    d = derive(p)
    r = P.col("l_receiptdate")
    m = P.isin("l_shipmode", [d["m1"], d["m2"]]) \
        & (r >= day(f"{p['year']}-01-01")) & (r < day(f"{p['year'] + 1}-01-01"))
    high = P.isin("o_orderpriority", ["1-URGENT", "2-HIGH"]).astype(np.int64)
    return P.group(["l_shipmode"], m, {"high_line_count": high,
                                       "low_line_count": 1 - high})

