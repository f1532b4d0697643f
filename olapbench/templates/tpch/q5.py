"""TPC-H Q5, local supplier volume (the port's flat-star form, which
groups by the supplier's nation within one region).

Substitution parameters (TPC-H spec 2.4.5.3): REGION, one of the 5;
DATE, January 1 of 1993-1997.
"""

SQL = """
select sn_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer c join orders o on c.c_custkey = o.o_custkey
     join lineitem l on l.l_orderkey = o.o_orderkey
     join supplier s on l.l_suppkey = s.s_suppkey
     join suppnation n on s.s_nationkey = n.sn_nationkey
     join suppregion r on n.sn_regionkey = r.sr_regionkey
where sr_name = '{region}'
      and o_orderdate >= date '{year}-01-01'
      and o_orderdate < date '{year1}-01-01'
group by sn_name
order by revenue desc
"""
DOMAIN = {"region": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
          "year": list(range(1993, 1998))}
ORDER = [("revenue", False)]
COLUMNS = ["sn_name", "l_extendedprice", "l_discount", "sr_name",
           "o_orderdate"]


def derive(p):
    return {"year1": p["year"] + 1}


def time_range(p):
    return None


def reference(t, p, P):
    from olapbench.plain import day
    o = P.col("o_orderdate")
    m = P.eq("sr_name", p["region"]) & (o >= day(f"{p['year']}-01-01")) \
        & (o < day(f"{p['year'] + 1}-01-01"))
    rev = P.num("l_extendedprice") * (P.f.type(1) - P.num("l_discount"))
    return P.group(["sn_name"], m, {"revenue": rev})
