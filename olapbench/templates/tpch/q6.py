"""TPC-H Q6, forecasting revenue change.

Substitution parameters (TPC-H spec 2.4.6.3): DATE, January 1 of
1993-1997; DISCOUNT, 0.02-0.09 (the filter is DISCOUNT +- 0.01);
QUANTITY, 24 or 25.
"""

SQL = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{year}-01-01'
      and l_shipdate < date '{year1}-01-01'
      and l_discount between {disc_lo} and {disc_hi}
      and l_quantity < {qty}
"""
DOMAIN = {"year": list(range(1993, 1998)), "disc": list(range(2, 10)),
          "qty": [24, 25]}
ORDER = []
COLUMNS = ["l_shipdate", "l_extendedprice", "l_discount", "l_quantity"]


def derive(p):
    return {"year1": p["year"] + 1, "disc_lo": f"0.{p['disc'] - 1:02d}",
            "disc_hi": f"0.{p['disc'] + 1:02d}"}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 1}-01-01"


def reference(t, p, P):
    from olapbench.plain import day
    s, c = P.col("l_shipdate"), P.cents("l_discount")
    m = (s >= day(f"{p['year']}-01-01")) & (s < day(f"{p['year'] + 1}-01-01")) \
        & (c >= p["disc"] - 1) & (c <= p["disc"] + 1) \
        & (P.col("l_quantity") < p["qty"])
    return P.total(m, {"revenue": P.num("l_extendedprice")
                       * P.num("l_discount")})
