"""The port's native string encoder against the numpy path and the JAX
package.

``segment/native.py`` builds ``csrc/segment_encoder.cpp`` (a copy of
``native/segment_encoder.cpp``) with g++ into ``build/torch_ext/`` at first
use. Its dictionaries and codes must equal, bit for bit, the port's numpy
path (``pandas.factorize``) and the JAX package's ``build_dim_column`` on
the same column: unicode, empty strings, one value, a column with NULLs
(which takes the numpy path in both packages), ``pd.StringDtype``, an
Arrow-backed column. A whole ingest with the encoder and without it gives
identical datasources, which equal the JAX package's.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import os
import time

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu.segment import native as jnative
from spark_druid_olap_tpu.segment.column import \
    build_dim_column as jbuild_dim
from spark_druid_olap_tpu.segment.ingest import ingest_dataframe as jingest

from spark_druid_olap_tpu_torch.segment import native
from spark_druid_olap_tpu_torch.segment.column import \
    build_dim_column as tbuild_dim
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest

from conftest import make_sales_df



@pytest.fixture(autouse=True)
def encoder_built():
    """Decided in a fixture, not at import: building the encoder is the
    first use."""
    if native.load() is None or jnative.load() is None:
        pytest.skip("g++ or pyarrow missing: both packages take the numpy "
                    "path")


def _columns():
    r = np.random.default_rng(3)
    words = ["", "a", "b", "ab", "é", "日本", "zz", "a b", "Ω", "é"]
    return {
        "mixed_unicode": pd.Series(r.choice(words, 5000)),
        "one_value": pd.Series(["only"] * 100),
        "empty_strings": pd.Series(["", "", "x", ""]),
        "with_nulls": pd.Series(["b", None, "a", None, "c"]),
        "string_dtype": pd.Series(r.choice(words[1:], 300),
                                  dtype="string"),
        "string_dtype_na": pd.Series(["q", pd.NA, "p"], dtype="string"),
        "arrow_backed": pd.Series(r.choice(words, 400),
                                  dtype="string[pyarrow]"),
        "object_array": np.array(["k", "j", "k", "", "ü"], dtype=object),
        "many": pd.Series([f"v{i:06d}" for i in
                           r.integers(0, 70_000, 200_000)]),
    }


COLS = _columns()
NULLABLE = {"with_nulls", "string_dtype_na"}


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.dictionary, dtype=object),
                                  np.asarray(b.dictionary, dtype=object))
    assert a.codes.dtype == b.codes.dtype
    np.testing.assert_array_equal(a.codes, b.codes)
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)


@pytest.fixture
def encoded(monkeypatch):
    """Whether each encoder call encoded (True) or declined (False)."""
    real, out = native.encode_strings, []

    def spy(raw):
        r = real(raw)
        out.append(r is not None)
        return r
    monkeypatch.setattr(native, "encode_strings", spy)
    return out


@pytest.fixture
def without_encoder(monkeypatch):
    """What a machine without g++ or pyarrow runs: the numpy path."""
    def off():
        monkeypatch.setattr(native, "load", lambda: None)
    return off


@pytest.mark.parametrize("name", sorted(COLS))
def test_encoder_equals_numpy_path_and_jax(name, encoded, without_encoder):
    raw = COLS[name]
    got = tbuild_dim(name, raw)
    assert encoded == [name not in NULLABLE]
    without_encoder()
    slow = tbuild_dim(name, raw)
    _same(got, slow)
    _same(got, jbuild_dim(name, raw))


def test_nulls_are_declined_by_the_encoder():
    assert native.encode_strings(COLS["with_nulls"]) is None
    assert native.encode_strings(COLS["string_dtype_na"]) is None


def _frame():
    df = make_sales_df(n=6000, seed=5)
    df["note"] = np.where(np.arange(len(df)) % 7 == 0, None, "n")
    return df


def test_ingest_with_and_without_the_encoder_is_identical(encoded,
                                                          without_encoder):
    df = _frame()
    fast = tingest("s", df, time_column="ts", target_rows=1024)
    # four string columns encoded; "note" has NULLs and declines
    assert sorted(encoded) == [False, True, True, True, True]
    without_encoder()
    slow = tingest("s", df, time_column="ts", target_rows=1024)
    ref = jingest("s", df, time_column="ts", target_rows=1024)
    for other in (slow, ref):
        assert list(fast.dims) == list(other.dims)
        assert list(fast.metrics) == list(other.metrics)
        for k in fast.dims:
            _same(fast.dims[k], other.dims[k])
        for k in fast.metrics:
            np.testing.assert_array_equal(fast.metrics[k].values,
                                          other.metrics[k].values)
        assert [(s.start_row, s.end_row) for s in fast.segments] \
            == [(s.start_row, s.end_row) for s in other.segments]


def test_build_lands_in_the_build_tree_and_follows_the_source(
        tmp_path, monkeypatch):
    """The library builds under ``build/``, never beside its source, and
    rebuilds when the source is newer than the build."""
    assert native._SO.parent.name == "torch_ext"
    assert native._SO.parent.parent.name == "build"
    assert native._SO.parent != native._SRC.parent
    src = tmp_path / "segment_encoder.cpp"
    src.write_bytes(native._SRC.read_bytes())
    so = tmp_path / "out" / "_sdot_native_torch.so"
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is not None and so.exists()
    first = so.stat().st_mtime
    time.sleep(0.05)
    os.utime(src, (first + 10, first + 10))
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is not None
    assert so.stat().st_mtime > first
