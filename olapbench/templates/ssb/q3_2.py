"""SSB Q3.2: revenue by customer city, supplier city and year within one
nation, over six years.

The paper's constants (c_nation = s_nation = UNITED STATES, 1992-1997)
move within their attributes: any of the 25 nations for both, any six
adjacent years of 1992-1998.
"""

from olapbench.data.ssb import NATIONS

SQL = """
select c_city, s_city, d_year, sum(lo_revenue) as lo_revenue
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
where c_nation = '{nation}' and s_nation = '{nation}'
      and d_year >= {year} and d_year <= {year_hi}
group by c_city, s_city, d_year
order by d_year asc, lo_revenue desc
"""
DOMAIN = {"nation": list(NATIONS), "year": [1992, 1993]}
ORDER = [("d_year", True), ("lo_revenue", False)]
COLUMNS = ["c_city", "s_city", "d_year", "lo_revenue", "c_nation",
           "s_nation"]


def derive(p):
    return {"year_hi": p["year"] + 5}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 6}-01-01"


def reference(t, p, P):
    m = P.eq("c_nation", p["nation"]) & P.eq("s_nation", p["nation"]) \
        & P.between("d_year", p["year"], p["year"] + 5)
    return P.group(["c_city", "s_city", "d_year"], m,
                   {"lo_revenue": P.num("lo_revenue")})
