"""JAX ``tests/test_extractions.py`` bound to the port: lookup and regex
dimension extractions.

The port runs with ``device="cpu"`` against the JAX test's pandas
transforms (exact: every answer is a count or a dimension value); each
statement's mode, the planned extraction (as serde JSON) and the unknown
lookup's error are held equal to the JAX package's on a twin context
with the same frame and lookup.

Original notes: lookup and regex dimension extractions (reference parity:
LookUpExtractionFunctionSpec / RegexExtractionFunctionSpec,
DruidQuerySpec.scala:31-103).

Differential pattern: engine extraction path vs pandas transforms.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ir.serde import dim_from_dict, dim_to_dict
from spark_druid_olap_tpu_torch.planner import builder as B
from spark_druid_olap_tpu_torch.sql.parser import parse_select

from spark_druid_olap_tpu.ir.serde import dim_to_dict as jdim_to_dict
from spark_druid_olap_tpu.planner import builder as JB
from spark_druid_olap_tpu.sql.parser import parse_select as jparse_select
from spark_druid_olap_tpu.sql.session import resolve_lookups as jresolve

from conftest import make_sales_df
from torch_twin import last_mode_as_jax, mirrored, same_error


@pytest.fixture(scope="module")
def ctx():
    c = mirrored(sdot.Context(device="cpu"))
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    zones = {"east": "atlantic", "west": "pacific", "north": "arctic"}
    c.register_lookup("region_zone", zones)
    c.jax.register_lookup("region_zone", zones)
    return c


@pytest.fixture(scope="module")
def sales(ctx):
    from spark_druid_olap_tpu_torch.planner.host_exec import datasource_frame
    return datasource_frame(ctx, "sales")


def test_lookup_grouping_pushes_down(ctx, sales):
    got = ctx.sql("select lookup(region, 'region_zone') as zone, "
                  "count(*) as c from sales group by "
                  "lookup(region, 'region_zone') order by zone").to_pandas()
    assert last_mode_as_jax(ctx) == "engine"
    zone = sales.region.map({"east": "atlantic", "west": "pacific",
                             "north": "arctic"})
    want = zone.groupby(zone, dropna=False).size()
    # 'south' is unmapped -> null zone group
    nulls = got[got.zone.isna()]
    assert len(nulls) == 1
    assert int(nulls.c.iloc[0]) == int((sales.region == "south").sum())
    nn = got[got.zone.notna()].set_index("zone")["c"]
    for z in ("atlantic", "pacific", "arctic"):
        assert int(nn[z]) == int(want[z])


def test_lookup_plan_is_lookup_extraction(ctx):
    from spark_druid_olap_tpu_torch.sql.session import resolve_lookups
    sql = ("select lookup(region, 'region_zone') as z, count(*) from sales "
           "group by lookup(region, 'region_zone')")
    pq = B.build(ctx, resolve_lookups(ctx, parse_select(sql)))
    dim = pq.specs[0].dimensions[0]
    jpq = JB.build(ctx.jax, jresolve(ctx.jax, jparse_select(sql)))
    assert dim_to_dict(dim) == jdim_to_dict(jpq.specs[0].dimensions[0])
    assert isinstance(dim.extraction, S.LookupExtraction)
    assert dict(dim.extraction.lookup)["east"] == "atlantic"


def test_lookup_in_filter(ctx, sales):
    got = ctx.sql("select count(*) as c from sales where "
                  "lookup(region, 'region_zone') = 'pacific'").to_pandas()
    assert int(got.c[0]) == int((sales.region == "west").sum())
    assert last_mode_as_jax(ctx) == "engine"


def test_unknown_lookup_raises(ctx):
    sql = "select lookup(region, 'nope') from sales limit 1"
    with pytest.raises(KeyError):
        ctx.sql(sql)
    same_error(lambda: ctx.sql(sql), lambda: ctx.jax.sql(sql))


def test_regexp_extract_grouping(ctx, sales):
    # product values are like 'p007' -> capture the last two digits
    got = ctx.sql(
        "select regexp_extract(product, 'p0*([0-9]+)$') as pid, "
        "count(*) as c from sales group by "
        "regexp_extract(product, 'p0*([0-9]+)$') order by pid").to_pandas()
    assert last_mode_as_jax(ctx) == "engine"
    want = sales["product"].str.extract(r"p0*([0-9]+)$")[0].value_counts()
    nn = got[got.pid.notna()].set_index("pid")["c"]
    assert len(nn) == len(want)
    for pid, cnt in want.items():
        assert int(nn[pid]) == int(cnt)


def test_regexp_extract_no_match_is_null(ctx, sales):
    got = ctx.sql("select count(*) as c from sales where "
                  "regexp_extract(region, '(zzz)') is null").to_pandas()
    assert int(got.c[0]) == len(sales)


def test_extraction_serde_roundtrip():
    d1 = S.DimensionSpec("r", "z", S.LookupExtraction(
        (("a", "x"), ("b", None)), retain_missing=True))
    assert dim_from_dict(dim_to_dict(d1)) == S.DimensionSpec(
        "r", "z", S.LookupExtraction((("a", "x"), ("b", None)), True, None))
    d2 = S.DimensionSpec("r", "z", S.RegexExtraction("p([0-9]+)", 1, True))
    assert dim_from_dict(dim_to_dict(d2)) == d2


def test_raw_query_with_lookup_extraction(ctx, sales):
    import json
    q = {"queryType": "groupBy", "dimensions": [
            {"dimension": "region", "outputName": "zone",
             "extractionFn": {"type": "lookup",
                              "lookup": {"type": "map",
                                         "map": {"east": "atlantic"}},
                              "retainMissingValue": True}}],
         "aggregations": [{"type": "count", "name": "c"}]}
    r = ctx.sql(f"ON DATASOURCE sales EXECUTE QUERY '{json.dumps(q)}'")
    df = r.to_pandas()
    assert set(df.zone) == {"atlantic", "west", "north", "south"}
    assert int(df.set_index("zone").c.sum()) == len(sales)
