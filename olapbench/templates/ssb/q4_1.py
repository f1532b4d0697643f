"""SSB Q4.1: profit by year and customer nation within one region, over
two manufacturers.

The paper's constants (c_region = s_region = AMERICA, p_mfgr MFGR#1 or
MFGR#2) move within their attributes: any of the 5 regions for both, any
two different manufacturers of the 5.
"""

SQL = """
select d_year, c_nation, sum(lo_revenue - lo_supplycost) as profit
from lineorder join date on lo_orderdate = d_datekey
     join customer on lo_custkey = c_custkey
     join supplier on lo_suppkey = s_suppkey
     join part on lo_partkey = p_partkey
where c_region = '{region}' and s_region = '{region}'
      and (p_mfgr = 'MFGR#{m1}' or p_mfgr = 'MFGR#{m2}')
group by d_year, c_nation order by d_year, c_nation
"""
DOMAIN = {"region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
          "mfgr": list(range(1, 6)), "step": list(range(1, 5))}
ORDER = [("d_year", True), ("c_nation", True)]
COLUMNS = ["d_year", "c_nation", "lo_revenue", "lo_supplycost", "c_region",
           "s_region", "p_mfgr"]


def derive(p):
    return {"m1": p["mfgr"], "m2": (p["mfgr"] - 1 + p["step"]) % 5 + 1}


def time_range(p):
    return None


def reference(t, p, P):
    d = derive(p)
    m = P.eq("c_region", p["region"]) & P.eq("s_region", p["region"]) \
        & P.isin("p_mfgr", [f"MFGR#{d['m1']}", f"MFGR#{d['m2']}"])
    return P.group(["d_year", "c_nation"], m,
                   {"profit": P.num("lo_revenue")
                    - P.num("lo_supplycost")})
