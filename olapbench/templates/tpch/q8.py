"""TPC-H Q8, national market share (the port's flat-star form: the
nation's revenue and the region's total by order year).

Substitution parameters (TPC-H spec 2.4.8.3): NATION, one of the 25;
REGION, the nation's region; TYPE, one of the 150 part types.
"""

from olapbench.data.tpch import NATIONS, REGIONS, TYPES

SQL = """
select year(o_orderdate) as o_year,
       sum(case when sn_name = '{nation}'
                then l_extendedprice * (1 - l_discount)
                else 0 end) as nation_rev,
       sum(l_extendedprice * (1 - l_discount)) as total_rev
from part p join lineitem l on p.p_partkey = l.l_partkey
     join supplier s on s.s_suppkey = l.l_suppkey
     join orders o on o.o_orderkey = l.l_orderkey
     join customer c on c.c_custkey = o.o_custkey
     join custnation n1 on c.c_nationkey = n1.cn_nationkey
     join custregion r1 on n1.cn_regionkey = r1.cr_regionkey
     join suppnation n2 on s.s_nationkey = n2.sn_nationkey
where cr_name = '{region}'
      and o_orderdate between date '1995-01-01' and date '1996-12-31'
      and p_type = '{type}'
group by year(o_orderdate)
order by o_year
"""
DOMAIN = {"n": list(range(25)), "type": list(TYPES)}
ORDER = [("o_year", True)]
COLUMNS = ["o_orderdate", "sn_name", "l_extendedprice", "l_discount",
           "cr_name", "p_type"]


def derive(p):
    name, region = NATIONS[p["n"]]
    return {"nation": name, "region": REGIONS[region]}


def time_range(p):
    return None


def reference(t, p, P):
    from olapbench.plain import day, year_of
    d = derive(p)
    o = P.col("o_orderdate")
    m = P.eq("cr_name", d["region"]) & P.eq("p_type", p["type"]) \
        & (o >= day("1995-01-01")) & (o <= day("1996-12-31"))
    rev = P.num("l_extendedprice") * (P.f.type(1) - P.num("l_discount"))
    mine = rev * P.eq("sn_name", d["nation"])
    return P.group(["o_year"], m, {"nation_rev": mine, "total_rev": rev},
                   key_values={"o_year": year_of(o)})
