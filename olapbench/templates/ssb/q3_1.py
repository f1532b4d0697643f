"""SSB Q3.1: revenue by customer nation, supplier nation and year within
one region, over six years.

The paper's constants (c_region = s_region = ASIA, 1992-1997) move within
their attributes: any of the 5 regions for both, any six adjacent years
of the generator's 1992-1998.
"""

SQL = """
select c_nation, s_nation, d_year, sum(lo_revenue) as lo_revenue
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
where c_region = '{region}' and s_region = '{region}'
      and d_year >= {year} and d_year <= {year_hi}
group by c_nation, s_nation, d_year
order by d_year asc, lo_revenue desc
"""
DOMAIN = {"region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
          "year": [1992, 1993]}
ORDER = [("d_year", True), ("lo_revenue", False)]
COLUMNS = ["c_nation", "s_nation", "d_year", "lo_revenue", "c_region",
           "s_region"]


def derive(p):
    return {"year_hi": p["year"] + 5}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 6}-01-01"


def reference(t, p, P):
    m = P.eq("c_region", p["region"]) & P.eq("s_region", p["region"]) \
        & P.between("d_year", p["year"], p["year"] + 5)
    return P.group(["c_nation", "s_nation", "d_year"], m,
                   {"lo_revenue": P.num("lo_revenue")})
