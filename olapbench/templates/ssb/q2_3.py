"""SSB Q2.3: revenue by year of one brand from one region's suppliers.

The paper's constants (p_brand1 MFGR#2239, s_region EUROPE) move within
their attributes: any of the 1,000 brands, any of the 5 regions.
"""

SQL = """
select sum(lo_revenue) as lo_revenue, d_year, p_brand1
from lineorder join date on lo_orderdate = d_datekey
     join part on lo_partkey = p_partkey
     join supplier on lo_suppkey = s_suppkey
where p_brand1 = 'MFGR#{mfgr}{cat}{brand:02d}' and s_region = '{region}'
group by d_year, p_brand1 order by d_year, p_brand1
"""
DOMAIN = {"mfgr": list(range(1, 6)), "cat": list(range(1, 6)),
          "brand": list(range(1, 41)),
          "region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]}
ORDER = [("d_year", True), ("p_brand1", True)]
COLUMNS = ["lo_revenue", "d_year", "p_brand1", "s_region"]


def derive(p):
    return {}


def time_range(p):
    return None


def reference(t, p, P):
    m = P.eq("p_brand1", f"MFGR#{p['mfgr']}{p['cat']}{p['brand']:02d}") \
        & P.eq("s_region", p["region"])
    g = P.group(["d_year", "p_brand1"], m, {"lo_revenue": P.num("lo_revenue")})
    return g[["lo_revenue", "d_year", "p_brand1"]]
