"""SSB Q2.2: revenue by year and brand over eight adjacent brands of one
category from one region's suppliers.

The paper's constants (p_brand1 MFGR#2221 to MFGR#2228, s_region ASIA)
move within their attributes: eight adjacent brands of any category,
starting at brand 1-33 of its 40, any of the 5 regions.
"""

SQL = """
select sum(lo_revenue) as lo_revenue, d_year, p_brand1
from lineorder join date on lo_orderdate = d_datekey
     join part on lo_partkey = p_partkey
     join supplier on lo_suppkey = s_suppkey
where p_brand1 between '{lo}' and '{hi}' and s_region = '{region}'
group by d_year, p_brand1 order by d_year, p_brand1
"""
DOMAIN = {"mfgr": list(range(1, 6)), "cat": list(range(1, 6)),
          "brand": list(range(1, 34)),
          "region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]}
ORDER = [("d_year", True), ("p_brand1", True)]
COLUMNS = ["lo_revenue", "d_year", "p_brand1", "s_region"]


def derive(p):
    head = f"MFGR#{p['mfgr']}{p['cat']}"
    return {"lo": f"{head}{p['brand']:02d}", "hi": f"{head}{p['brand'] + 7:02d}"}


def time_range(p):
    return None


def reference(t, p, P):
    d = derive(p)
    m = P.between("p_brand1", d["lo"], d["hi"]) \
        & P.eq("s_region", p["region"])
    g = P.group(["d_year", "p_brand1"], m, {"lo_revenue": P.num("lo_revenue")})
    return g[["lo_revenue", "d_year", "p_brand1"]]
