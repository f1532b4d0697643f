"""TPC-H Q14, promotion effect.

Substitution parameter (TPC-H spec 2.4.14.3): DATE, the first day of a
month of 1993-1997.
"""

SQL = """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem l join part p on l.l_partkey = p.p_partkey
where l_shipdate >= date '{start}'
      and l_shipdate < date '{end}'
"""
DOMAIN = {"year": list(range(1993, 1998)), "month": list(range(1, 13))}
ORDER = []
COLUMNS = ["l_shipdate", "p_type", "l_extendedprice", "l_discount"]


def derive(p):
    y, m = p["year"], p["month"]
    return {"start": f"{y}-{m:02d}-01",
            "end": f"{y + 1}-01-01" if m == 12 else f"{y}-{m + 1:02d}-01"}


def time_range(p):
    d = derive(p)
    return d["start"], d["end"]


def reference(t, p, P):
    from olapbench.plain import day
    d = derive(p)
    s = P.col("l_shipdate")
    m = (s >= day(d["start"])) & (s < day(d["end"]))
    rev = P.num("l_extendedprice") * (P.f.type(1) - P.num("l_discount"))
    g = P.total(m, {"promo": rev * P.prefix("p_type", "PROMO"),
                    "all": rev})
    return g.assign(promo_revenue=100.0 * g["promo"] / g["all"])[
        ["promo_revenue"]]
