"""SSB Q1.1: revenue of a year's discounted small orders.

The paper's constants (d_year 1993, lo_discount 1-3, lo_quantity < 25)
move within their attributes: any year of the generator's 1992-1998, any
three adjacent discounts of 0-10; the quantity bound stays.
"""

SQL = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date on lo_orderdate = d_datekey
where d_year = {year} and lo_discount between {disc} and {disc_hi}
      and lo_quantity < 25
"""
DOMAIN = {"year": list(range(1992, 1999)), "disc": list(range(0, 9))}
ORDER = []
COLUMNS = ["d_year", "lo_discount", "lo_quantity", "lo_extendedprice"]


def derive(p):
    return {"disc_hi": p["disc"] + 2}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 1}-01-01"


def reference(t, p, P):
    m = P.eq("d_year", p["year"]) \
        & P.between("lo_discount", p["disc"], p["disc"] + 2) \
        & (P.col("lo_quantity") < 25)
    return P.total(m, {"revenue": P.num("lo_extendedprice")
                       * P.num("lo_discount")})
