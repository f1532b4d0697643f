"""The plain reference agrees with the port's answers on the CPU, for every
template of every configuration, through the server's JSON encoding."""

import json

import numpy as np
import pytest

from conftest import ROOT
from olapbench import catalog, compare, traffic
from olapbench.plain import Plain

CONFIGS = ["ssb_sf1", "tpch_sf1"]


def _cfg(name):
    return json.loads((ROOT / "olapbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.fixture(scope="module", params=CONFIGS)
def served(request):
    import importlib

    import spark_druid_olap_tpu_torch as sdt
    from olapbench.run import star_schema
    cfg = _cfg(request.param)
    gen = importlib.import_module(f"olapbench.data.{cfg['generator']}")
    table = gen.generate(0.02, 41)
    ctx = sdt.Context(dict(cfg["context"]), device="cpu")
    ctx.ingest_dataframe(cfg["datasource"], table.frame(),
                         time_column=cfg["time_column"],
                         target_rows=cfg["segment_rows"])
    ctx.register_star_schema(star_schema(cfg["star_schema"],
                                         cfg["datasource"]))
    return cfg, table, ctx


def test_every_template_agrees(served):
    from spark_druid_olap_tpu_torch.server.http import _df_to_json_rows
    cfg, table, ctx = served
    rng = np.random.default_rng(5)
    for name, tpl in catalog.templates(cfg).items():
        for _ in range(3):
            p = traffic.draw(tpl, rng)
            body = json.loads(_df_to_json_rows(
                ctx.sql(traffic.sql(tpl, p)).to_pandas()))
            assert ctx.history.entries()[-1].stats["mode"] == "engine", name
            P = Plain(table)
            ref = tpl.reference(table, p, P)
            fault, err = compare.judge(ref, P.keys, P.scales, tpl.ORDER,
                                       body["columns"], body["rows"])
            assert fault is None, (name, p, fault)
            assert err <= cfg["guarantees"].get("float_err", 0.0), \
                (name, p, err)
