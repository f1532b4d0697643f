"""TPC-H Q1, pricing summary report (the port's flat-star form).

Substitution parameter (TPC-H spec 2.4.1.3): DELTA, 60 to 120 days.
"""

SQL = """
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
where l_shipdate <= date '1998-12-01' - interval '{delta}' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
DOMAIN = {"delta": list(range(60, 121))}
ORDER = [("l_returnflag", True), ("l_linestatus", True)]
COLUMNS = ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax"]


def derive(p):
    return {}


def time_range(p):
    import numpy as np
    last = np.datetime64("1998-12-01") - np.timedelta64(p["delta"], "D")
    return None, str(last + np.timedelta64(1, "D"))


def reference(t, p, P):
    from olapbench.plain import day
    m = P.col("l_shipdate") <= day("1998-12-01") - p["delta"]
    price, disc = P.num("l_extendedprice"), P.num("l_discount")
    one = P.f.type(1)
    dprice = price * (one - disc)
    return P.group(["l_returnflag", "l_linestatus"], m, {
        "sum_qty": P.col("l_quantity"),
        "sum_base_price": price,
        "sum_disc_price": dprice,
        "sum_charge": dprice * (one + P.num("l_tax")),
        "avg_qty": ("avg", P.num("l_quantity")),
        "avg_price": ("avg", price),
        "avg_disc": ("avg", disc),
        "count_order": "count"})
