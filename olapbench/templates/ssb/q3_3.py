"""SSB Q3.3: revenue by city pair and year between two cities of one
nation, over six years.

The paper's constants (UNITED KI1 and UNITED KI5, 1992-1997) move within
their attributes: any two different cities of any one nation (the
generator's cities are the nation's first 9 letters and a digit), any six
adjacent years of 1992-1998.
"""

from olapbench.data.ssb import NATIONS

SQL = """
select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
where (c_city = '{city1}' or c_city = '{city2}')
      and (s_city = '{city1}' or s_city = '{city2}')
      and d_year >= {year} and d_year <= {year_hi}
group by c_city, s_city, d_year
order by d_year asc, lo_revenue desc
"""
DOMAIN = {"nation": list(NATIONS), "digit": list(range(10)),
          "step": list(range(1, 10)), "year": [1992, 1993]}
ORDER = [("d_year", True), ("lo_revenue", False)]
COLUMNS = ["c_city", "s_city", "d_year", "lo_revenue"]


def derive(p):
    head = f"{p['nation'][:9]:<9}"
    return {"city1": f"{head}{p['digit']}",
            "city2": f"{head}{(p['digit'] + p['step']) % 10}",
            "year_hi": p["year"] + 5}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 6}-01-01"


def reference(t, p, P):
    d = derive(p)
    cities = [d["city1"], d["city2"]]
    m = P.isin("c_city", cities) & P.isin("s_city", cities) \
        & P.between("d_year", p["year"], p["year"] + 5)
    return P.group(["c_city", "s_city", "d_year"], m,
                   {"lo_revenue": P.num("lo_revenue")})
