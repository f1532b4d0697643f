"""The reference's "Ship Date Range" statement (BenchMarkDetails.org):
lines by return flag and status shipped within three years.

Its constants (1994-01-01 to 1997-01-01) move within the attribute: any
three-year span starting on January 1 of 1992-1995, so the span keeps its
length inside the generator's ship dates (1992-01-02 to 1998-12).
"""

SQL = """
select l_returnflag, l_linestatus, count(*) as count_order
from lineitem
where l_shipdate >= date '{year}-01-01' and l_shipdate <= date '{year3}-01-01'
group by l_returnflag, l_linestatus
"""
DOMAIN = {"year": list(range(1992, 1996))}
ORDER = []
COLUMNS = ["l_shipdate", "l_returnflag", "l_linestatus"]


def derive(p):
    return {"year3": p["year"] + 3}


def time_range(p):
    return f"{p['year']}-01-01", f"{p['year'] + 3}-01-02"


def reference(t, p, P):
    from olapbench.plain import day
    s = P.col("l_shipdate")
    m = (s >= day(f"{p['year']}-01-01")) & (s <= day(f"{p['year'] + 3}-01-01"))
    return P.group(["l_returnflag", "l_linestatus"], m, {"count_order": "count"})
