"""TPC-H Q7, volume shipping between two nations (the port's flat-star
form).

Substitution parameters (TPC-H spec 2.4.7.3): NATION1 and NATION2, two
different nations of the 25.
"""

from olapbench.data.tpch import NATIONS

SQL = """
select sn_name, cn_name, year(l_shipdate) as l_year,
       sum(l_extendedprice * (1 - l_discount)) as revenue
from supplier s join lineitem l on s.s_suppkey = l.l_suppkey
     join orders o on o.o_orderkey = l.l_orderkey
     join customer c on c.c_custkey = o.o_custkey
     join suppnation n1 on s.s_nationkey = n1.sn_nationkey
     join custnation n2 on c.c_nationkey = n2.cn_nationkey
where ((sn_name = '{n1}' and cn_name = '{n2}')
       or (sn_name = '{n2}' and cn_name = '{n1}'))
      and l_shipdate between date '1995-01-01' and date '1996-12-31'
group by sn_name, cn_name, year(l_shipdate)
order by sn_name, cn_name, l_year
"""
DOMAIN = {"nation": list(range(25)), "step": list(range(1, 25))}
ORDER = [("sn_name", True), ("cn_name", True), ("l_year", True)]
COLUMNS = ["sn_name", "cn_name", "l_shipdate", "l_extendedprice",
           "l_discount"]


def derive(p):
    return {"n1": NATIONS[p["nation"]][0],
            "n2": NATIONS[(p["nation"] + p["step"]) % 25][0]}


def time_range(p):
    return "1995-01-01", "1997-01-01"


def reference(t, p, P):
    from olapbench.plain import day, year_of
    d = derive(p)
    s = P.col("l_shipdate")
    pair = (P.eq("sn_name", d["n1"]) & P.eq("cn_name", d["n2"])) \
        | (P.eq("sn_name", d["n2"]) & P.eq("cn_name", d["n1"]))
    m = pair & (s >= day("1995-01-01")) & (s <= day("1996-12-31"))
    rev = P.num("l_extendedprice") * (P.f.type(1) - P.num("l_discount"))
    return P.group(["sn_name", "cn_name", "l_year"], m, {"revenue": rev},
                   key_values={"l_year": year_of(s)})
