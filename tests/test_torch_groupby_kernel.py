"""The port's fused dense group-by against the JAX package's.

The JAX side runs ``ops/groupby.dense_groupby`` with ``SDOT_PALLAS=interpret``,
so its fused Pallas kernel really runs (interpreted) through ``plan_routes``
and ``combine_route``, as ``tests/test_pallas.py`` drives it. The port side
runs the CUDA kernel's plain PyTorch version (``dense_groupby_reference``,
which ``dense_groupby_kernel`` takes for CPU tensors) and the engine-level
``dense_groupby`` routing. Inputs come from numpy with a fixed seed.

Tolerance: integers, counts and min/max exact; float sums rtol 1e-6, because
the JAX kernel sums f32 per lane (Neumaier pairs) and the port sums in f64.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from spark_druid_olap_tpu.ops import groupby as JG
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import groupby as TG

FLOAT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def force_interpret(monkeypatch):
    monkeypatch.setenv("SDOT_PALLAS", "interpret")


def _rand_inputs(n, n_keys=5, seed=0):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, n_keys, n, dtype=np.int32),
            "mask": rng.random(n) < 0.9,
            "v": rng.random(n, dtype=np.float32),
            "iv": rng.integers(-1000, 1000, n, dtype=np.int32),
            "am": rng.random(n) < 0.5}


# (name, kind, value column or None, filtered, is_int, maxabs)
_AGGS = [("s", "sum", "v", False, False, 1.0),
         ("c", "count", None, False, True, 1.0),
         ("cf", "count", None, True, True, 1.0),
         ("sf", "sum", "v", True, False, 1.0),
         ("si", "sum", "iv", False, True, 1000.0),
         ("mn", "min", "v", False, False, None),
         ("mnf", "min", "v", True, False, None),
         ("mx", "max", "v", True, False, None),
         ("mni", "min", "iv", False, True, 1000.0),
         ("mxi", "max", "iv", True, True, 1000.0),
         ("__rows__", "count", None, False, True, 1.0)]


def _run_jax(d, n_keys, aggs, pallas_max):
    inputs = [JG.AggInput(name, kind,
                          None if col is None else jnp.asarray(d[col]),
                          jnp.asarray(d["am"]) if filt else None,
                          is_int=is_int, maxabs=maxabs)
              for name, kind, col, filt, is_int, maxabs in aggs]
    routes = JG.plan_routes(inputs, n_keys, 4096, pallas_max=pallas_max)
    out = JG.dense_groupby(jnp.asarray(d["key"]), jnp.asarray(d["mask"]),
                           n_keys, inputs, routes, 4096)
    host = {k: np.asarray(x) for k, x in out.items()}
    return routes, {a.name: JG.combine_route(routes[a.name], host, n_keys)
                    for a in inputs}


def _port_inputs(d, aggs):
    return [TG.AggInput(name, kind,
                        None if col is None else torch.from_numpy(d[col]),
                        torch.from_numpy(d["am"]) if filt else None,
                        is_int=is_int)
            for name, kind, col, filt, is_int, _ in aggs]


def _run_port_reference(d, n_keys, aggs):
    key = np.where(d["mask"], d["key"], n_keys).astype(np.int32)
    out = CG.dense_groupby_reference(torch.from_numpy(key), n_keys,
                                     _port_inputs(d, aggs))
    return {k: v.numpy() for k, v in out.items()}


def _run_port_engine(d, n_keys, aggs, pallas_max):
    inputs = _port_inputs(d, aggs)
    routes = TG.plan_routes(inputs)
    out = TG.dense_groupby(torch.from_numpy(d["key"]),
                           torch.from_numpy(d["mask"]), n_keys, inputs,
                           routes, pallas_max)
    host = {k: v.numpy() for k, v in out.items()}
    return {a.name: TG.combine_route(routes[a.name], host, n_keys)
            for a in inputs}


def _assert_match(got, want, aggs):
    assert sorted(got) == sorted(want)
    for name, kind, col, _, is_int, _ in aggs:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if kind == "sum" and not is_int:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n", [1000, 70_000])
def test_reference_matches_jax_pallas_kernel(n):
    d = _rand_inputs(n)
    routes, want = _run_jax(d, 5, _AGGS, pallas_max=64)
    assert routes["s"].tag == "ffl"      # the Pallas kernel really ran
    _assert_match(_run_port_reference(d, 5, _AGGS), want, _AGGS)


@pytest.mark.parametrize("n_keys,pallas_max", [(5, 64), (5, 0), (100, 64)])
def test_engine_routing_matches_jax(n_keys, pallas_max):
    """The port's dense_groupby (kernel tier for K <= pallas max, scatter
    tier above it or when disabled) against the JAX routes."""
    d = _rand_inputs(20_000, n_keys=n_keys, seed=3)
    _, want = _run_jax(d, n_keys, _AGGS, pallas_max=pallas_max)
    _assert_match(_run_port_engine(d, n_keys, _AGGS, pallas_max), want,
                  _AGGS)


def test_empty_groups_keep_sentinels():
    d = _rand_inputs(4096)
    d["key"][:] = 0                          # groups 1..4 empty
    aggs = [a for a in _AGGS if a[0] in ("mn", "mx", "mni", "mxi",
                                         "__rows__")]
    _, want = _run_jax(d, 5, aggs, pallas_max=64)
    got = _run_port_reference(d, 5, aggs)
    _assert_match(got, want, aggs)
    assert np.all(got["mn"][1:] == np.inf)
    assert np.all(got["mx"][1:] == -np.inf)
    assert np.all(got["mni"][1:] == JG.I64_MAX)
    assert np.all(got["mxi"][1:] == JG.I64_MIN)
    assert np.all(got["__rows__"][1:] == 0)


def test_all_rows_masked_out():
    d = _rand_inputs(2048)
    d["mask"][:] = False
    _, want = _run_jax(d, 5, _AGGS, pallas_max=64)
    got = _run_port_reference(d, 5, _AGGS)
    _assert_match(got, want, _AGGS)
    assert np.all(got["__rows__"] == 0) and np.all(got["s"] == 0)
    assert np.all(got["mn"] == np.inf)


def test_int_sums_exact_past_2_24():
    rng = np.random.default_rng(7)
    n = 300_000
    d = {"key": rng.integers(0, 3, n, dtype=np.int32),
         "mask": np.ones(n, dtype=bool),
         "iv": rng.integers(0, 1000, n, dtype=np.int32),
         "am": np.ones(n, dtype=bool)}
    aggs = [("si", "sum", "iv", False, True, 1000.0),
            ("__rows__", "count", None, False, True, 1.0)]
    routes, want = _run_jax(d, 3, aggs, pallas_max=64)
    assert routes["si"].tag == "ffl"
    got = _run_port_reference(d, 3, aggs)
    exact = np.zeros(3, dtype=np.int64)
    np.add.at(exact, d["key"], d["iv"].astype(np.int64))
    assert exact.max() > 2 ** 24
    np.testing.assert_array_equal(got["si"], exact)
    np.testing.assert_array_equal(np.rint(want["si"]).astype(np.int64),
                                  exact)
    np.testing.assert_array_equal(got["__rows__"],
                                  np.bincount(d["key"], minlength=3))


def test_kernel_wrapper_takes_plain_version_on_cpu():
    d = _rand_inputs(5000)
    key = torch.from_numpy(np.where(d["mask"], d["key"], 5)
                           .astype(np.int32))
    inputs = _port_inputs(d, _AGGS)
    before = CG.launches
    got = CG.dense_groupby_kernel(key, 5, inputs, 64)
    want = CG.dense_groupby_reference(key, 5, inputs)
    assert CG.launches == before          # no kernel on a CPU tensor
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("case", ["key_dtype", "too_many_keys", "kind",
                                  "ragged_values", "mask_dtype",
                                  "no_values"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    n = 64
    key = torch.zeros(n, dtype=torch.int32)
    v = torch.ones(n, dtype=torch.float32)
    a = TG.AggInput("s", "sum", v)
    if case == "key_dtype":
        key = key.long()
    elif case == "kind":
        a = TG.AggInput("s", "median", v)
    elif case == "ragged_values":
        a = TG.AggInput("s", "sum", torch.ones(n + 1))
    elif case == "mask_dtype":
        a = TG.AggInput("s", "sum", v, mask=torch.ones(n, dtype=torch.int32))
    elif case == "no_values":
        a = TG.AggInput("s", "sum", None)
    n_keys = 65 if case == "too_many_keys" else 4
    with pytest.raises(ValueError):
        CG._check(key, n_keys, [a], 64)


def test_nan_propagates_like_jax():
    """A NaN value makes its group's float min, max and sum NaN on both
    sides; masked-out NaNs change nothing."""
    d = _rand_inputs(5000)
    d["v"][[3, 40, 41]] = np.nan
    d["key"][[3, 40, 41]] = [1, 2, 2]
    d["mask"][[3, 40, 41]] = True
    d["am"][[3, 40, 41]] = [True, False, False]
    aggs = [a for a in _AGGS if a[0] in ("s", "sf", "mn", "mnf", "mx",
                                         "__rows__")]
    _, want = _run_jax(d, 5, aggs, pallas_max=64)
    got = _run_port_reference(d, 5, aggs)
    _assert_match(got, want, aggs)
    for name in ("s", "mn"):
        assert np.isnan(got[name][[1, 2]]).all(), name
        assert not np.isnan(got[name][[0, 3, 4]]).any(), name
    for name in ("sf", "mnf", "mx"):                 # filtered: only row 3
        assert np.isnan(got[name][1]) and not np.isnan(got[name][2]), name


def test_many_aggregates_take_the_kernel_tier():
    """More aggregates than one kernel launch takes still route to the
    kernel tier (it launches once per group of them) and match JAX."""
    aggs = [(f"{name}{i}", kind, col, filt, is_int, maxabs)
            for i in range(2)
            for name, kind, col, filt, is_int, maxabs in _AGGS
            if name != "__rows__"] + [_AGGS[-1]]
    assert len(aggs) > CG.MAX_AGGS
    d = _rand_inputs(20_000, n_keys=6, seed=5)
    assert TG.use_kernel(6, _port_inputs(d, aggs), 64)
    _, want = _run_jax(d, 6, aggs, pallas_max=64)
    _assert_match(_run_port_engine(d, 6, aggs, 64), want, aggs)
