"""Mesh elasticity of the port against the JAX package's.

From JAX ``tests/test_elasticity.py``: after an explicit ``reshard`` or a
re-attach that finds fewer live slots, the engine rebuilds its mesh over
the devices it is given (or that answer) and keeps serving sharded; a
reshard to one device unshards; a re-attach that finds the same mesh
keeps it. The port's mesh is ``("cpu",) * 8``; where JAX's re-attach reads
``jax.devices()``, the port's reads ``executor._live_devices`` (the
mesh's slots whose device answers a probe), which the test patches. The
answers are held against the first answer and the JAX package's on its
emulated mesh (floats rtol 1e-9 within the port, 1e-5 against JAX, where
float metrics are stored float32 and summed in another order).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import unittest.mock as mock

import jax
import numpy as np
import pandas as pd

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.parallel import executor as TX
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh, mesh_size

CONF = {"sdot.querycostmodel.enabled": False,
        "sdot.engine.backend.retry.seconds": 0.0}

SQL = ("select k, sum(v) as s, count(*) as c from t "
       "group by k order by k")


def _frame():
    rng = np.random.default_rng(21)
    n = 20_000
    return pd.DataFrame({"k": rng.choice(list("abcdefgh"), n),
                         "v": rng.normal(10, 3, n).round(3)})


def _ctx():
    ctx = tsdot.Context(config=CONF, mesh=make_mesh(devices=("cpu",) * 8))
    ctx.ingest_dataframe("t", _frame(), target_rows=1024)
    return ctx


def _jax_answer(n_devices):
    j = jsdot.Context(config=CONF, mesh=jmake_mesh(n_devices))
    j.ingest_dataframe("t", _frame(), target_rows=1024)
    return j.sql(SQL).to_pandas()


def _stats(ctx):
    return ctx.history.entries()[-1].stats


def test_explicit_reshard_shrink_keeps_serving_sharded():
    ctx = _ctx()
    base = ctx.sql(SQL).to_pandas()
    assert _stats(ctx)["sharded"]
    assert mesh_size(ctx.mesh) == 8
    pd.testing.assert_frame_equal(base, _jax_answer(8), check_dtype=False,
                                  rtol=1e-5)

    ctx.reshard(("cpu",) * 4)                # "half the cards died"
    assert mesh_size(ctx.mesh) == 4
    assert ctx.engine.last_stats["resharded_to"] == 4
    r = ctx.sql(SQL).to_pandas()
    st = _stats(ctx)
    assert st["sharded"] and st["devices"] == 4, st
    pd.testing.assert_frame_equal(r, base, check_dtype=False, rtol=1e-9)
    pd.testing.assert_frame_equal(r, _jax_answer(4), check_dtype=False,
                                  rtol=1e-5)

    ctx.reshard(("cpu",) * 6)                # partial restore
    assert mesh_size(ctx.mesh) == 6
    r = ctx.sql(SQL).to_pandas()
    assert _stats(ctx)["sharded"]
    pd.testing.assert_frame_equal(r, base, check_dtype=False, rtol=1e-9)


def test_reshard_to_single_device_unshards():
    ctx = _ctx()
    base = ctx.sql(SQL).to_pandas()
    ctx.reshard(("cpu",))
    assert ctx.mesh is None and ctx.engine.mesh is None
    r = ctx.sql(SQL).to_pandas()
    assert not _stats(ctx).get("sharded")
    pd.testing.assert_frame_equal(r, base, check_dtype=False, rtol=1e-9)


def test_reattach_reshards_onto_changed_device_set(monkeypatch):
    """Backend loss -> host tier; when the re-attach finds FEWER live
    slots, it rebuilds the mesh over them instead of binding dead ones."""
    ctx = _ctx()
    base = ctx.sql(SQL).to_pandas()
    eng = ctx.engine
    eng._mark_backend_lost()
    assert eng._backend_lost_at is not None

    monkeypatch.setattr(TX, "_probe_device_alive", lambda *a, **k: True)
    monkeypatch.setattr(TX, "_live_devices",
                        lambda mesh: list(mesh)[:4])
    assert eng._try_reattach()
    assert eng._backend_lost_at is None
    assert mesh_size(eng.mesh) == 4
    assert eng.last_stats.get("resharded_to") == 4

    monkeypatch.undo()
    r = ctx.sql(SQL).to_pandas()
    st = _stats(ctx)
    assert st["mode"] == "engine" and st["sharded"], st
    pd.testing.assert_frame_equal(r, base, check_dtype=False, rtol=1e-9)
    pd.testing.assert_frame_equal(r, _jax_answer(4), check_dtype=False,
                                  rtol=1e-5)
    assert len(jax.devices()) == 8


def test_reattach_same_size_does_not_reshard():
    ctx = _ctx()
    eng = ctx.engine
    mesh_before = eng.mesh
    eng._mark_backend_lost()
    with mock.patch.object(TX, "_probe_device_alive", return_value=True):
        assert eng._try_reattach()
    assert eng.mesh is mesh_before           # no churn on a clean probe
    assert "resharded_to" not in eng.last_stats
