"""The generators are deterministic per seed, and every seed makes the same
amount of data."""

import json

import pandas as pd
import pytest

from conftest import ROOT

from olapbench.data import ssb, tpch


@pytest.mark.parametrize("gen", [ssb, tpch], ids=["ssb", "tpch"])
def test_same_seed_same_frame(gen):
    a = gen.generate(0.005, 2**31 + 5).frame()
    b = gen.generate(0.005, 2**31 + 5).frame()
    pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("gen", [ssb, tpch], ids=["ssb", "tpch"])
def test_other_seed_same_size_other_values(gen):
    a = gen.generate(0.005, 7).frame()
    b = gen.generate(0.005, 8).frame()
    assert a.shape == b.shape and list(a.columns) == list(b.columns)
    assert not a.equals(b)


@pytest.mark.parametrize("gen,config,n", [(ssb, "ssb_sf1", 58),
                                          (tpch, "tpch_sf1", 68)],
                         ids=["ssb", "tpch"])
def test_flat_widths(gen, config, n):
    """Every column of the source, each with its stored width."""
    cfg = json.loads((ROOT / "olapbench" / "configs" / f"{config}.json")
                     .read_text())
    frame = gen.generate(0.005, 1).frame()
    assert frame.shape[1] == n
    assert list(frame.columns) == list(cfg["widths"])
