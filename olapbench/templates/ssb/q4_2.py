"""SSB Q4.2: profit by year, supplier nation and category within one
region, over two adjacent years and two manufacturers.

The paper's constants (AMERICA, 1997 or 1998, MFGR#1 or MFGR#2) move
within their attributes: any region, any two adjacent years of 1992-1998,
any two different manufacturers.
"""

SQL = """
select d_year, s_nation, p_category, sum(lo_revenue - lo_supplycost) as profit
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
     join part on lo_partkey = p_partkey
where c_region = '{region}' and s_region = '{region}'
      and (d_year = {year} or d_year = {year2})
      and (p_mfgr = 'MFGR#{m1}' or p_mfgr = 'MFGR#{m2}')
group by d_year, s_nation, p_category
order by d_year, s_nation, p_category
"""
DOMAIN = {"region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
          "year": list(range(1992, 1998)), "mfgr": list(range(1, 6)),
          "step": list(range(1, 5))}
ORDER = [("d_year", True), ("s_nation", True), ("p_category", True)]
COLUMNS = ["d_year", "s_nation", "p_category", "lo_revenue",
           "lo_supplycost", "c_region", "s_region", "p_mfgr"]


def derive(p):
    return {"year2": p["year"] + 1, "m1": p["mfgr"],
            "m2": (p["mfgr"] - 1 + p["step"]) % 5 + 1}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 2}-01-01"


def reference(t, p, P):
    d = derive(p)
    m = P.eq("c_region", p["region"]) & P.eq("s_region", p["region"]) \
        & P.isin("d_year", [p["year"], p["year"] + 1]) \
        & P.isin("p_mfgr", [f"MFGR#{d['m1']}", f"MFGR#{d['m2']}"])
    return P.group(["d_year", "s_nation", "p_category"], m,
                   {"profit": P.num("lo_revenue")
                    - P.num("lo_supplycost")})
