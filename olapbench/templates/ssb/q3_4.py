"""SSB Q3.4: revenue by city pair between two cities of one nation in one
month.

The paper's constants (UNITED KI1 and UNITED KI5, Dec1997) move within
their attributes: any two different cities of any one nation, any month
of 1992-1998.
"""

from olapbench.data.ssb import MONTHS, NATIONS

SQL = """
select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
where (c_city = '{city1}' or c_city = '{city2}')
      and (s_city = '{city1}' or s_city = '{city2}')
      and d_yearmonth = '{ym}'
group by c_city, s_city, d_year
order by d_year asc, lo_revenue desc
"""
DOMAIN = {"nation": list(NATIONS), "digit": list(range(10)),
          "step": list(range(1, 10)), "year": list(range(1992, 1999)),
          "month": list(range(1, 13))}
ORDER = [("d_year", True), ("lo_revenue", False)]
COLUMNS = ["c_city", "s_city", "d_year", "lo_revenue", "d_yearmonth"]


def derive(p):
    head = f"{p['nation'][:9]:<9}"
    return {"city1": f"{head}{p['digit']}",
            "city2": f"{head}{(p['digit'] + p['step']) % 10}",
            "ym": f"{MONTHS[p['month'] - 1]}{p['year']}"}


def time_range(p):
    y, m = p["year"], p["month"]
    nxt = f"{y + 1}-01-01" if m == 12 else f"{y}-{m + 1:02d}-01"
    return f"{y}-{m:02d}-01", nxt


def reference(t, p, P):
    d = derive(p)
    cities = [d["city1"], d["city2"]]
    m = P.isin("c_city", cities) & P.isin("s_city", cities) \
        & P.eq("d_yearmonth", d["ym"])
    return P.group(["c_city", "s_city", "d_year"], m,
                   {"lo_revenue": P.num("lo_revenue")})
