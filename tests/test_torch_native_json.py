"""JAX ``tests/test_native_json.py`` bound to the port: the native
result-set JSON encoder (the port's ``segment/native`` module, built from
the port's own C++ source).

Differential, the JAX test's own oracle: the C++ encoder's output equals
the python json path, across types, nulls, escaping and timestamps; the
declines (unsupported dtypes, uint64 past 2^63) are its closed forms."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu_torch.segment import native


def conv(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, float) and v != v:
        return None
    if isinstance(v, (np.floating,)):
        f = float(v)
        return None if f != f else f
    if isinstance(v, (np.datetime64, pd.Timestamp)):
        return pd.Timestamp(v).isoformat()
    if v is None or v is pd.NaT:
        return None
    return v


def oracle(df):
    return [{c: conv(v) for c, v in zip(df.columns, row)}
            for row in df.itertuples(index=False, name=None)]


@pytest.fixture(scope="module")
def mod():
    m = native.load()
    if m is None or not hasattr(m, "encode_json_rows"):
        pytest.skip("native module unavailable")
    return m


def test_types_nulls_escaping(mod):
    df = pd.DataFrame({
        "f": [1.5, float("nan"), 2.25e-10, 1e20],
        "i": np.array([1, -7, 2 ** 40, 0], dtype=np.int64),
        "s": ["plain", 'quo"te\\back\n\t', "unié中", None],
        "b": [True, False, True, False],
        "ts": pd.to_datetime(["2015-01-01", "2016-06-15 12:34:56.789",
                              None, "1969-12-31 23:59:59"], format="mixed"),
    })
    got = json.loads(native.encode_json_rows(df))
    assert got == oracle(df)


def test_empty_frame(mod):
    df = pd.DataFrame({"a": np.array([], dtype=np.float64),
                       "b": np.array([], dtype=object)})
    assert json.loads(native.encode_json_rows(df)) == []


def test_server_payload_uses_native(mod):
    from spark_druid_olap_tpu_torch.server.http import _df_to_json_rows
    df = pd.DataFrame({"x": [1.0, 2.0], "y": ["a", "b"]})
    full = json.loads(_df_to_json_rows(df))
    assert full["columns"] == ["x", "y"]
    assert full["numRows"] == 2
    assert full["rows"] == oracle(df)


def test_unsupported_dtype_falls_back(mod):
    df = pd.DataFrame({"c": pd.Categorical(["a", "b"])})
    assert native.encode_json_rows(df) is None


def test_matches_python_path_on_query_results():
    # end-to-end shape: a real engine result through the server encoder
    import spark_druid_olap_tpu_torch as sdot
    from conftest import make_sales_df
    from spark_druid_olap_tpu_torch.server.http import _df_to_json_rows
    ctx = sdot.Context(device="cpu")
    ctx.ingest_dataframe("s1", make_sales_df(5000), time_column="ts")
    df = ctx.sql("select region, flag, sum(price) as rev, count(*) as c "
                 "from s1 group by region, flag order by region, flag") \
        .to_pandas()
    full = json.loads(_df_to_json_rows(df))
    assert full["rows"] == oracle(df)
    assert full["numRows"] == len(df)


def test_uint64_overflow_falls_back(mod):
    # uint64 values >= 2**63 would wrap negative through int64; the native
    # route must decline so the Python encoder renders them correctly
    df = pd.DataFrame({"u": np.array([1, 2 ** 63 + 5], dtype=np.uint64)})
    assert native.encode_json_rows(df) is None
    small = pd.DataFrame({"u": np.array([1, 42], dtype=np.uint64)})
    out = native.encode_json_rows(small)
    assert out is not None and json.loads(out) == [{"u": 1}, {"u": 42}]
