"""SSB Q1.2: revenue of one month's discounted mid-size orders.

The paper's constants (d_yearmonthnum 199401, lo_discount 4-6,
lo_quantity 26-35) move within their attributes: any month of 1992-1998,
any three adjacent discounts of 0-10, any ten adjacent quantities of 1-50.
"""

SQL = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date on lo_orderdate = d_datekey
where d_yearmonthnum = {ym} and lo_discount between {disc} and {disc_hi}
      and lo_quantity between {qty} and {qty_hi}
"""
DOMAIN = {"year": list(range(1992, 1999)), "month": list(range(1, 13)),
          "disc": list(range(0, 9)), "qty": list(range(1, 42))}
ORDER = []
COLUMNS = ["d_yearmonthnum", "lo_discount", "lo_quantity",
           "lo_extendedprice"]


def derive(p):
    return {"ym": p["year"] * 100 + p["month"], "disc_hi": p["disc"] + 2,
            "qty_hi": p["qty"] + 9}


def time_range(p):
    y, m = p["year"], p["month"]
    nxt = f"{y + 1}-01-01" if m == 12 else f"{y}-{m + 1:02d}-01"
    return f"{y}-{m:02d}-01", nxt


def reference(t, p, P):
    m = P.eq("d_yearmonthnum", p["year"] * 100 + p["month"]) \
        & P.between("lo_discount", p["disc"], p["disc"] + 2) \
        & P.between("lo_quantity", p["qty"], p["qty"] + 9)
    return P.total(m, {"revenue": P.num("lo_extendedprice")
                       * P.num("lo_discount")})
