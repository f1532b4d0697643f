"""SSB Q1.3: revenue of one week's discounted mid-size orders.

The paper's constants (week 6 of 1994, lo_discount 5-7, lo_quantity 26-35)
move within their attributes: any ISO week 1-52 of any year of 1992-1998,
any three adjacent discounts, any ten adjacent quantities.
"""

SQL = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date on lo_orderdate = d_datekey
where d_weeknuminyear = {week} and d_year = {year}
      and lo_discount between {disc} and {disc_hi}
      and lo_quantity between {qty} and {qty_hi}
"""
DOMAIN = {"year": list(range(1992, 1999)), "week": list(range(1, 53)),
          "disc": list(range(0, 9)), "qty": list(range(1, 42))}
ORDER = []
COLUMNS = ["d_weeknuminyear", "d_year", "lo_discount", "lo_quantity",
           "lo_extendedprice"]


def derive(p):
    return {"disc_hi": p["disc"] + 2, "qty_hi": p["qty"] + 9}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 1}-01-01"


def reference(t, p, P):
    m = P.eq("d_weeknuminyear", p["week"]) & P.eq("d_year", p["year"]) \
        & P.between("lo_discount", p["disc"], p["disc"] + 2) \
        & P.between("lo_quantity", p["qty"], p["qty"] + 9)
    return P.total(m, {"revenue": P.num("lo_extendedprice")
                       * P.num("lo_discount")})
