"""The port's spatial filter against the JAX package's.

The cases of ``tests/test_spatial.py`` through both packages: the same
seeded points frame goes into a JAX ``Context`` and a port
``Context(device="cpu")`` with ``spatial_dims={"pickup": ["lat", "lon"]}``.
Covered: the collapse of range predicates into one ``SpatialFilter``
(plans equal field by field), the answer against the JAX engine and pandas
(counts exact, float sums rtol 1e-6), the segment pruning by bounding box
(the same kept segments in both, and an answer equal to the unpruned
one), open sides, the ingest validation, a spatial select and search, and
the filter as one lane of a storm (the JAX package lowers it in the lane
too) answering as it does solo.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.planner import builder as JB
from spark_druid_olap_tpu.sql.parser import parse_select as jparse

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.planner import builder as TB
from spark_druid_olap_tpu_torch.planner.host_exec import datasource_frame
from spark_druid_olap_tpu_torch.sql.parser import parse_select as tparse

from test_spatial import BOX_SQL, make_points
from test_torch_sql import assert_answers_equal


@pytest.fixture(scope="module")
def pair():
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("trips", make_points(), time_column="ts",
                           target_rows=4096,
                           spatial_dims={"pickup": ["lat", "lon"]})
    yield jctx, tctx
    jctx.close()


def _both(pair, sql, ordered=False):
    want = pair[0].sql(sql).to_pandas()
    got = pair[1].sql(sql).to_pandas()
    assert_answers_equal(got, want, ordered)
    js, ts = (c.history.entries()[-1].stats for c in pair)
    assert ts["mode"] == js["mode"] == "engine"
    assert ts["segments"] == js["segments"]
    return got


def test_datasource_carries_the_spatial_map(pair):
    assert pair[1].store.get("trips").spatial \
        == pair[0].store.get("trips").spatial == {"pickup": ("lat", "lon")}


@pytest.mark.parametrize("sql", [BOX_SQL, (
    "select count(*) as c from trips where lat >= 30 and lat <= 45")])
def test_bounds_collapse_to_the_same_spatial_filter(pair, sql):
    jf = JB.build(pair[0], jparse(sql)).specs[0].filter
    tf = TB.build(pair[1], tparse(sql)).specs[0].filter
    assert isinstance(tf, TS.SpatialFilter) and isinstance(
        jf, JS.SpatialFilter)
    assert (tf.dimension, tf.axes, tf.min_coords, tf.max_coords) \
        == (jf.dimension, jf.axes, jf.min_coords, jf.max_coords)


def test_spatial_query_matches_jax_and_pandas(pair):
    got = _both(pair, BOX_SQL, ordered=True)
    trips = datasource_frame(pair[1], "trips")
    want = trips[(trips.lat >= 10) & (trips.lat <= 20) &
                 (trips.lon >= -50) & (trips.lon <= 40)] \
        .groupby("city").agg(c=("fare", "size"), f=("fare", "sum")) \
        .reset_index().sort_values("city").reset_index(drop=True)
    assert list(got["city"]) == list(want["city"])
    np.testing.assert_array_equal(got["c"].to_numpy(), want["c"].to_numpy())
    np.testing.assert_allclose(got["f"], want["f"], rtol=1e-6)


def test_spatial_prunes_the_same_segments(pair):
    f = [m.SpatialFilter("pickup", ("lat", "lon"), (10.0, -np.inf),
                         (20.0, np.inf)) for m in (JS, TS)]
    kept = [c.store.get("trips").prune_segments(None, g)
            for c, g in zip(pair, f)]
    n = pair[1].store.get("trips").num_segments
    np.testing.assert_array_equal(kept[1], kept[0])
    assert 0 < len(kept[1]) < n
    _both(pair, BOX_SQL, ordered=True)
    assert pair[1].history.entries()[-1].stats["segments"] == len(kept[1])


def test_pruned_answer_equals_the_unpruned_one(pair, monkeypatch):
    """The same box with every segment kept (pruning switched off) gives
    the same answer: pruning drops only segments no row of which lies in
    the box."""
    pruned = pair[1].sql(BOX_SQL).to_pandas()
    ds = pair[1].store.get("trips")
    monkeypatch.setattr(ds, "_filter_keep_mask",
                        lambda f: np.ones(ds.num_segments, dtype=bool))
    full = pair[1].sql(BOX_SQL).to_pandas()
    assert pair[1].history.entries()[-1].stats["segments"] \
        == ds.num_segments
    assert_answers_equal(pruned, full, ordered=True)


def test_numeric_bound_zone_map_pruning_equal(pair):
    for lower in (55.0, 1e9):
        kept = [c.store.get("trips").prune_segments(
            None, m.BoundFilter("lat", lower=lower, numeric=True))
            for c, m in zip(pair, (JS, TS))]
        np.testing.assert_array_equal(kept[1], kept[0])


def test_partial_box_open_sides(pair):
    sql = "select count(*) as c from trips where lat >= 30 and lat <= 45"
    got = _both(pair, sql)
    trips = datasource_frame(pair[1], "trips")
    assert int(got["c"][0]) == int(((trips.lat >= 30)
                                    & (trips.lat <= 45)).sum())
    f = TB.build(pair[1], tparse(sql)).specs[0].filter
    assert f.min_coords[1] == -np.inf and f.max_coords[1] == np.inf


def test_spatial_dim_validation_in_both():
    for ctx in (jsdot.Context(), tsdot.Context(device="cpu")):
        with pytest.raises(ValueError, match="not a numeric column"):
            ctx.ingest_dataframe("bad", make_points(100),
                                 spatial_dims={"p": ["lat", "city"]})


def test_spatial_select_and_search_equal(pair):
    """The executor's filter-to-expression branch: a select and a search
    under a spatial filter answer as the JAX engine's."""
    box = [m.SpatialFilter("pickup", ("lat", "lon"), (10.0, -50.0),
                           (20.0, 40.0)) for m in (JS, TS)]
    sel = [c.execute(m.SelectQuerySpec(
        "trips", columns=("city", "fare", "lat"), filter=f,
        page_size=50)).to_pandas()
        for m, c, f in zip((JS, TS), pair, box)]
    assert_answers_equal(sel[1], sel[0], ordered=True)
    srch = [c.execute(m.SearchQuerySpec(
        "trips", dimensions=("city",), query="n", filter=f)).to_pandas()
        for m, c, f in zip((JS, TS), pair, box)]
    assert_answers_equal(srch[1], srch[0], ordered=False)
    assert len(sel[1]) == 50 and len(srch[1]) > 0
