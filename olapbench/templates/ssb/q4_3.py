"""SSB Q4.3: profit by year, supplier city and brand for one supplier
nation and one category, over two adjacent years.

The paper's constants (c_region AMERICA, s_nation UNITED STATES, 1997 or
1998, p_category MFGR#14) move within their attributes: any nation with
its own region as the customers' region, any two adjacent years of
1992-1998, any of the 25 categories.
"""

from olapbench.data.ssb import NATIONS, REGIONS

SQL = """
select d_year, s_city, p_brand1, sum(lo_revenue - lo_supplycost) as profit
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
     join part on lo_partkey = p_partkey
where c_region = '{region}' and s_nation = '{nation}'
      and (d_year = {year} or d_year = {year2})
      and p_category = 'MFGR#{mfgr}{cat}'
group by d_year, s_city, p_brand1
order by d_year, s_city, p_brand1
"""
DOMAIN = {"nation": list(NATIONS), "year": list(range(1992, 1998)),
          "mfgr": list(range(1, 6)), "cat": list(range(1, 6))}
ORDER = [("d_year", True), ("s_city", True), ("p_brand1", True)]
COLUMNS = ["d_year", "s_city", "p_brand1", "lo_revenue", "lo_supplycost",
           "c_region", "s_nation", "p_category"]


def derive(p):
    return {"region": REGIONS[NATIONS.index(p["nation"]) // 5],
            "year2": p["year"] + 1}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 2}-01-01"


def reference(t, p, P):
    d = derive(p)
    m = P.eq("c_region", d["region"]) & P.eq("s_nation", p["nation"]) \
        & P.isin("d_year", [p["year"], p["year"] + 1]) \
        & P.eq("p_category", f"MFGR#{p['mfgr']}{p['cat']}")
    return P.group(["d_year", "s_city", "p_brand1"], m,
                   {"profit": P.num("lo_revenue")
                    - P.num("lo_supplycost")})
